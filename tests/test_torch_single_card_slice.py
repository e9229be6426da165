"""The last single-card slice end to end, on the CPU.

One flow through the slice's modules against the JAX package's on the same
files: a cohort bundled into OME-TIFFs by the JAX package, loaded by the
port's loader, its channels' 99.9% quantiles by bisection, one channel
thresholded and cleaned (small objects and holes) and labeled; every step
bitwise the JAX package's. Then chip_smoke's phase (m) rehearsed at a small
size on the CPU, with the card's timers stubbed: its checks pass, it
launches none of the port's kernels, and its trace check refuses a trace
that holds no CUDA kernel.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ark_tpu.io import load_utils as JL
from ark_tpu.io import ome_utils as JO
from ark_tpu.ops import cc as jcc
from ark_tpu.ops import quantiles as jq
from ark_tpu_torch.io import load_utils as TL
from ark_tpu_torch.ops import cc as tcc
from ark_tpu_torch.ops import quantiles as tq
from tests import test_utils

torch.set_num_threads(2)

CHANNELS = ["CD3", "CD45", "ECAD", "dsDNA"]


def test_ome_to_cleaned_labels_matches_jax(tmp_path):
    test_utils.create_image_cohort(str(tmp_path / "tree"), ["fov0", "fov1"], CHANNELS,
                                   shape=(48, 40))
    for fov in ("fov0", "fov1"):
        JO.fov_to_ome(str(tmp_path / "tree" / fov), str(tmp_path / "ome"))
    got = TL.load_imgs_from_mibitiff(str(tmp_path / "ome"), dtype=np.float32)
    want = JL.load_imgs_from_mibitiff(str(tmp_path / "ome"), dtype=np.float32)
    np.testing.assert_array_equal(got.values, want.values)
    pixels = got.values.reshape(-1, len(CHANNELS))
    valid = np.arange(pixels.shape[0]) % 7 != 0
    q = tq.masked_quantile_per_column_bisect(torch.from_numpy(pixels),
                                             torch.from_numpy(valid), 0.999)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.masked_quantile_per_column_bisect(
        jnp.asarray(pixels), jnp.asarray(valid), 0.999)))
    for i in range(2):
        mask = got.values[i, ..., CHANNELS.index("dsDNA")] > 0.5 * float(q[3])
        kept = tcc.remove_small_objects(mask, 4, device="cpu")
        filled = tcc.remove_small_holes_np(kept.numpy(), 6, device="cpu")
        labels, n = tcc.label_np(filled, 2, device="cpu")
        j_kept = jcc.remove_small_objects(jnp.asarray(mask), 4)
        j_filled = jcc.remove_small_holes_np(np.asarray(j_kept), 6)
        j_labels, j_n = jcc.label_np(j_filled, 2)
        np.testing.assert_array_equal(kept.numpy(), np.asarray(j_kept))
        np.testing.assert_array_equal(filled, j_filled)
        np.testing.assert_array_equal(labels, j_labels)
        assert n == j_n > 0


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke on the CPU at a small size: the card's timers stubbed."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CARD", "no card (CPU rehearsal)")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps=10: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "kernels_per_call", lambda fn: (fn(), (1.0, 0))[1])
    monkeypatch.setattr(chip_smoke, "CC_SIZES", (48, 64))
    monkeypatch.setattr(chip_smoke, "QUANT_SHAPE", (6000, 16))
    monkeypatch.setattr(chip_smoke, "QUANT_CPU_ROWS", 1500)
    monkeypatch.setattr(chip_smoke, "PREFETCH_FOVS", 3)
    monkeypatch.setattr(chip_smoke, "PREFETCH_SIZE", 64)
    return chip_smoke


def test_phase_m_rehearses_on_the_cpu(smoke, monkeypatch):
    traced = []
    monkeypatch.setattr(smoke, "check_trace", lambda pool: traced.append(1) or 7)
    # the phase reads differences and resets no counter: the real wrappers'
    # counts stand at 5 before it and after
    for name, (module, *_) in smoke.KERNELS.items():
        monkeypatch.setattr(getattr(importlib.import_module(f"ark_tpu_torch.ops.{module}"),
                                    name), "launches", 5)
    seen = []
    real_since = smoke.launches_since
    monkeypatch.setattr(smoke, "launches_since",
                        lambda before: seen.append(real_since(before)) or seen[-1])
    cc_t, quant_t, prefetch_t, kernels = smoke.run_single_card_modules()
    launches = [seen[0][name] for name in smoke.KERNELS]
    assert traced == [1] and kernels == 7 and launches == [0] * 7
    assert smoke.launch_counts() == dict.fromkeys(smoke.KERNELS, 5)
    assert set(cc_t) == {(name, size) for size in (48, 64) for name in (
        "label (connectivity 1)", "label (connectivity 2)", "area_filter",
        "remove_small_objects", "remove_small_holes")}
    assert set(quant_t) == {"nonzero_quantile_per_column", "masked_quantile_per_column"}
    seq_s, pre_s, loads = prefetch_t
    assert seq_s > 0 and pre_s > 0 and loads > 0


def test_phase_m_trace_check_refuses_a_trace_without_kernels(smoke):
    """On the CPU the trace holds host ops only: the check fails, as it
    must wherever no CUDA kernel ran."""
    with pytest.raises(smoke.SmokeFailure, match="no CUDA kernel event"):
        smoke.check_trace(smoke.prefetch_pool())
