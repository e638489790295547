"""Solver pipelines: models/zhegvdx_planar.py (planar complex zhegvdx)."""
