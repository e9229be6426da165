"""Spatial LDA of the port: neighborhood featurization, MST difference
matrices, topic EDA and the EM's training and inference (``ark_tpu/spLDA``)."""
