"""Pixie pixel-clustering stage of the port (mirrors ark_tpu.phenotyping)."""
