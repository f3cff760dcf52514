"""Wavelet descriptions."""
