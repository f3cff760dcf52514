"""Geometry, test images and device helpers."""
