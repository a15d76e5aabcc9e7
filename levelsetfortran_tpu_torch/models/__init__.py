"""Analytic SDFs and procedural meshes."""
