"""Mesmer segmentation on PyTorch."""
