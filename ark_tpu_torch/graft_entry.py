"""The port's analog of ``__graft_entry__.entry()``: the flagship model's
forward step and its example arguments.

``entry(device=...)`` returns ``(forward, (model, x))``: the published
Mesmer PanopticNet (ResNet50, 256-channel FPN, 64/128-wide heads) in f32
with seeded weights on `device`, a (1, 128, 128, 2) input, and a forward
that returns the whole-cell inner-distance and pixelwise heads, without
autograd and with TF32 off. The JAX package's ``dryrun_multichip`` (a
sharded training step) has no analog yet: it waits for the port's
multi-GPU work.
"""

from __future__ import annotations

import torch

from ark_tpu_torch.models import unet


def entry(*, device="cuda"):
    """Return (forward, (model, x)) for one Mesmer forward on `device`."""
    model = unet.init_mesmer(seed=0, dtype=torch.float32, device=device)

    def forward(model, x):
        with torch.inference_mode(), unet.full_f32():
            out = model(x)
        return out["whole_cell_inner_distance"], out["whole_cell_pixelwise"]

    x = torch.ones((1, 128, 128, 2), dtype=torch.float32, device=device)
    return forward, (model, x)
