"""Three-term roofline model (one NVIDIA H100 SXM; the counterpart of
``repro.analysis.roofline``, whose constants are another chip's).

  compute   = FLOPs       / (chips × 989 TFLOP/s dense bf16)
  memory    = bytes       / (chips × 3.35 TB/s HBM3)
  collective= coll_bytes  / (50 GB/s per NVLink link)

The constants are the H100 SXM datasheet's (H100 80GB HBM3, 700.00 W
power limit): dense bf16 tensor-core peak, HBM3 bandwidth, and the NVLink 4
rate of one link (900 GB/s over 18 links).  One card exercises no
collective, so the last term is the datasheet's and never measured.  The
dominant term is the predicted bottleneck; MODEL_FLOPS/FLOPs measures how
much compute is "useful" (remat recompute shows up here by design).
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12          # dense bf16 per card (H100 SXM datasheet)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
NVLINK_BW = 50e9             # bytes/s per NVLink link (900 GB/s / 18)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float             # whole-program HLO flops (all chips)
    bytes_accessed: float
    collective_bytes: float
    chips: int
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound ~ max term (perfect overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of peak the *useful* model FLOPs achieve at the predicted
        step time (the score §Perf optimizes)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "bytes": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "step_time_s": self.step_time_s,
            "chips": self.chips,
        }


def roofline(cost: dict, coll_bytes: float, chips: int,
             model_flops: float = 0.0,
             per_device: bool = True) -> RooflineTerms:
    """Build terms from a cost dict (``"flops"``, ``"bytes accessed"``)
    and collective bytes.

    per_device: the cost numbers are per device (then scaled by ``chips``
    to the whole program); collective bytes are always per device.
    """
    flops = float(cost.get("flops", 0.0))
    bts = float(cost.get("bytes accessed", 0.0))
    if per_device:
        total_flops = flops * chips
        total_bytes = bts * chips
    else:
        total_flops, total_bytes = flops, bts
    per_chip_flops = total_flops / chips
    per_chip_bytes = total_bytes / chips
    return RooflineTerms(
        compute_s=per_chip_flops / PEAK_FLOPS,
        memory_s=per_chip_bytes / HBM_BW,
        collective_s=float(coll_bytes) / NVLINK_BW,
        flops=total_flops,
        bytes_accessed=total_bytes,
        collective_bytes=float(coll_bytes),
        chips=chips,
        model_flops=model_flops,
    )


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D for a train step (fwd+bwd)."""
    return 6.0 * cfg.active_param_count() * tokens


def model_flops_decode(cfg, batch: int) -> float:
    """2·N_active per generated token (fwd only), × batch."""
    return 2.0 * cfg.active_param_count() * batch


def model_flops_prefill(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_param_count() * tokens
