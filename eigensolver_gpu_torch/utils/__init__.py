"""Configuration, precision policy, kernel loader, tracing, timing, test
fixtures and conversion helpers."""
