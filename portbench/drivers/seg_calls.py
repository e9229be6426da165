"""Closed loop of template-1 segmentation calls: ``mesmer.segment_fovs`` on
one batch after another, cycling through a pool of seeded FOVs.

Set-up draws the pool on the device from the seed and the network's weights
from the configuration's ``weights_seed``, scales the inner-distance heads'
last layer over one FOV of that seed (``inputs.calibrate_inner``), builds
the app once (the published PanopticNet with those weights), and warms up with calls on every batch of
the pool. In the window a call counts once its masks are in host memory.
Calls drawn from the seed keep the network's heads (a forward hook) and
their masks for the check."""

from __future__ import annotations

import time

import numpy as np

from portbench import inputs
from portbench.counts import panoptic_flops
from portbench.reference import panoptic as reference
from portbench.reference.compare import partition_mismatch

NET_KEYS = ("stage_sizes", "base_width", "fpn_channels", "head_upsample_filters",
            "head_dense_features", "location", "inner_activation")
SAMPLED_CALLS = 2
PHASE_CALLS = 8


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, workdir: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.workdir = device, workdir
        self.batch = traffic["batch_size"]
        self.records = {}
        self._capture = None
        self.samples = []

    def setup(self):
        import torch

        from ark_tpu_torch.models import unet
        from ark_tpu_torch.segmentation import mesmer

        cfg, tr = self.cfg, self.traffic
        self.pool = inputs.tissue_fovs(self.seed, tr["pool_fovs"], cfg["fov_size"],
                                       tr["cells_per_fov"], self.device)
        # one fixed set of weights for every seed, as a deployment runs one
        # checkpoint over every FOV: weights drawn from the seed changed the
        # flood's work from seed to seed by up to half
        wseed = cfg["weights_seed"]
        state = inputs.panoptic_state(reference.param_shapes(cfg), wseed, self.device)
        calib = inputs.tissue_fovs(wseed, 1, cfg["fov_size"], tr["cells_per_fov"],
                                   self.device)[0]
        self.state = inputs.calibrate_inner(cfg, state, calib, self.device)
        if self.device != "cpu":
            # the calibration's plain forward is the harness's, not the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
        model = unet.PanopticNet(compartments=tuple(cfg["compartments"]), dtype=dtype,
                                 **{k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
                                    for k in NET_KEYS})
        model.load_state_dict(self.state)
        self.app = mesmer.Mesmer(model=model, device=self.device)
        self._hook = self.app.model.register_forward_hook(self._keep_heads)
        for i in range(tr["pool_fovs"] // self.batch):
            self.call(i)

    def _keep_heads(self, module, args, output):
        if self._capture is not None:
            self._capture.update({k: v.detach().clone() for k, v in output.items()})

    def _batch(self, i: int) -> np.ndarray:
        n = self.pool.shape[0]
        lo = (i * self.batch) % n
        return self.pool[lo:lo + self.batch]

    def call(self, i: int):
        from ark_tpu_torch.segmentation import mesmer

        cfg = self.cfg
        return mesmer.segment_fovs(
            self._batch(i), app=self.app, batch_size=self.batch, device=self.device,
            postprocess=cfg["postprocess"], maxima_threshold=cfg["maxima_threshold"],
            interior_threshold=cfg["interior_threshold"], min_cell_size=cfg["min_cell_size"])

    def captured_call(self, i: int):
        """(heads, masks) of call i, outside any window."""
        heads = self._capture = {}
        try:
            return heads, self.call(i)
        finally:
            self._capture = None

    def window(self, seconds: float, traced: bool) -> dict:
        import torch

        rng = inputs.host_rng(self.seed, 6)
        restore = self._label_phases() if traced else None
        calls, failed, attempted = 0, 0, 0
        t0 = time.perf_counter()
        t_end = t0
        try:
            while time.perf_counter() - t0 < seconds:
                i = attempted
                attempted += 1
                # reservoir of SAMPLED_CALLS calls, drawn before the call
                slot = None
                if len(self.samples) < SAMPLED_CALLS:
                    slot = len(self.samples)
                else:
                    j = int(rng.integers(0, i + 1))
                    slot = j if j < SAMPLED_CALLS else None
                heads = {} if slot is not None else None
                self._capture = heads
                try:
                    if traced:
                        with torch.profiler.record_function("portbench.call"):
                            out = self.call(i)
                    else:
                        out = self.call(i)
                except Exception as exc:    # a failed call is counted, the loop goes on
                    failed += 1
                    self.records.setdefault("errors", []).append(repr(exc)[:500])
                    t_end = time.perf_counter()
                    continue
                finally:
                    self._capture = None
                t_end = time.perf_counter()
                calls += 1
                if slot is not None:
                    sample = (i, heads, out)
                    if slot == len(self.samples):
                        self.samples.append(sample)
                    else:
                        self.samples[slot] = sample
        finally:
            if restore:
                restore()
        flop = panoptic_flops.forward_flop(self.cfg, self.cfg["fov_size"],
                                           self.cfg["fov_size"]) * self.batch
        self.records.update({"calls": calls, "attempted": attempted, "failed": failed,
                             "fovs": calls * self.batch, "call_flop": flop,
                             "host_fallbacks": self.app.host_fallbacks})
        return {"fovs_per_s": calls * self.batch / (t_end - t0) if calls else None}

    def _label_phases(self):
        """Name the app's phases and its upload and readback in the trace."""
        import torch

        app = self.app

        def phase(name):
            return torch.profiler.record_function("portbench." + name)
        saved = {name: getattr(app, name) for name in ("_upload", "_finish_device_post")}
        for name, fn in saved.items():
            def wrapped(*a, _fn=fn, _n=name, **k):
                with torch.profiler.record_function("portbench." + _n.strip("_")):
                    return _fn(*a, **k)
            setattr(app, name, wrapped)
        app._phase = phase

        def restore():
            for name in (*saved, "_phase"):
                delattr(app, name)
        return restore

    def traced_extras(self):
        """Seconds of each postprocess phase per call, over calls of their own
        made with the app's phase clock on."""
        self.app.timings = {}
        for i in range(PHASE_CALLS):
            self.call(i)
        self.records["phase_s"] = dict(self.app.timings)
        self.records["phase_calls"] = PHASE_CALLS
        self.app.timings = None

    def release(self):
        """Free the program's state before the reference runs."""
        import torch

        self._hook.remove()
        self.app = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        if not self.samples:
            raise RuntimeError("no call finished in the window, so none was checked")
        numbers = {}
        for i, heads, out in self.samples:
            want = reference.heads(self.cfg, self.state, self._batch(i), self.device)
            got = compare(self.cfg, heads, out, want)
            numbers = {k: max(v, numbers.get(k, 0.0)) for k, v in got.items()}
        self.records["head_rms_gap"] = numbers.pop("head_rms_gap")
        self.records["checked_calls"] = [i for i, _, _ in self.samples]
        self.records["instances"] = sum(
            len(np.unique(m)) - 1 for _, _, out in self.samples
            for comp in self.cfg["compartments"] for m in out[comp])
        return numbers


def compare(cfg: dict, heads: dict, masks: dict, want: dict) -> dict:
    """Gaps of a call's heads to the reference heads `want` (largest over the
    four heads: the largest difference over the largest reference value, and
    the norm of the difference over the norm of the reference, which is
    reported but not compared), and the share of pixels whose masks disagree,
    as partitions, in the worst image, with the plain postprocess of the
    call's own heads: the heads are judged against the reference above, and
    the postprocess on what it was given, since a bfloat16 head moves
    markers and ties that the float32 reference does not have."""
    import torch

    rms = mx = mism = 0.0
    for name, ref in want.items():
        diff = heads[name].to(torch.float32) - ref
        rms = max(rms, float(torch.linalg.vector_norm(diff)
                             / torch.clamp_min(torch.linalg.vector_norm(ref), 1e-30)))
        mx = max(mx, float(diff.abs().max() / torch.clamp_min(ref.abs().max(), 1e-30)))
    labels = reference.postprocess(heads, cfg["compartments"], cfg["maxima_threshold"],
                                   cfg["interior_threshold"], cfg["min_cell_size"])
    for comp in cfg["compartments"]:
        for got_b, want_b in zip(masks[comp], labels[comp]):
            mism = max(mism, partition_mismatch(got_b, want_b))
    return {"head_rms_gap": rms, "head_max_gap": mx, "mask_mismatch": mism}
