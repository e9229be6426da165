"""ark_tpu_torch: the PyTorch and CUDA port of ark_tpu.

It mirrors ark_tpu's layout and names (``ark_tpu_torch/ops/som.py`` is the
port of ``ark_tpu/ops/som.py``, and so on) and never imports jax; the JAX
package stays the reference that the port's tests hold it against. Device
work runs on an explicit ``device``: a CUDA tensor goes through the port's
hand-written kernels (``ark_tpu_torch/csrc``, built with nvcc on first use)
and never falls back to the plain torch version, which CPU tensors use.
The jax-free host layer (``ark_tpu.io``) is imported, not copied.
"""

__version__ = "0.1.0"
