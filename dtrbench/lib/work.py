"""The table of peaks and the least work a kernel call needs.

Frozen copies of ``chip_smoke.py``'s bound arithmetic (``bound``,
``attention_bound_ms``, ``flash_bwd_bound_ms``, ``gemm_bound_ms``,
``wkv_bound_ms``, ``visible_pairs``), in seconds instead of
milliseconds, with two changes the benchmark needs: the grouped GEMM counts
the rows its call really fills (the kept expert assignments, not the
capacity buffer), and its backward (dX and dW) is counted beside its
forward.  A call's least time is the larger of its bytes, each input read
once and each output written once, over the memory rate, and its
operations over the peak rate for the type.
"""
from __future__ import annotations

# H100 SXM, dense rates (NVIDIA's data sheet), at its 700 W limit.
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
# The peak a step's model FLOPs are held to (mfu): bf16 on the tensor cores.
MFU_PEAK_OPS_PER_S = PEAK_OPS_PER_S["bfloat16"]


def bound_s(nbytes: float, flops: float, dtype_name: str) -> float:
    """The larger of bytes over the memory rate and operations over the
    peak rate for the type, in seconds."""
    return max(nbytes / MEM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype_name])


def visible_pairs(b: int, sq: int, skv: int, window: int = 0) -> int:
    """Visible (query, key) pairs of one head under a bottom-right causal
    mask, and a sliding window of ``window`` keys if > 0, over the batch."""
    return b * sum(min(skv, i + skv - sq + 1, window or skv)
                   for i in range(sq))


def attention_fwd_work(b, hq, hkv, sq, skv, d, itemsize, *, causal=True,
                       window=0, lse=True):
    """``(bytes, flops)`` of the attention forward: q, k, v read once, the
    output (and with ``lse`` each row's f32 log-sum-exp) written once;
    q.k and p.v products of the visible pairs only."""
    pairs = visible_pairs(b, sq, skv, window) if causal else b * sq * skv
    nbytes = (2 * b * hq * sq * d + 2 * b * skv * hkv * d) * itemsize \
        + (4 * b * hq * sq if lse else 0)
    return nbytes, 4 * hq * d * pairs


def attention_bwd_work(b, hq, hkv, sq, skv, d, itemsize, *, causal=True,
                       window=0):
    """``(bytes, flops)`` of the attention backward: q, k, v, o, dO and the
    f32 LSE read once and dq, dk, dv written once, against its five
    score-area products (S, dP, dV, dQ, dK: 2 * D FLOPs each per visible
    pair and query head)."""
    pairs = visible_pairs(b, sq, skv, window) if causal else b * sq * skv
    nbytes = (4 * b * hq * sq * d + 4 * b * hkv * skv * d) * itemsize \
        + 4 * b * hq * sq
    return nbytes, 10 * hq * d * pairs


def gemm_fwd_work(e, rows, d, f, itemsize):
    """``(bytes, flops)`` of the grouped GEMM forward over ``rows`` filled
    rows (the kept assignments, summed over the experts): those rows and
    the ``e`` experts' weights read once, the rows' outputs written once;
    2 FLOPs per multiply-add of every filled row."""
    return (rows * d + e * d * f + rows * f) * itemsize, 2 * rows * d * f


def gemm_bwd_work(e, rows, d, f, itemsize):
    """``(bytes, flops)`` of the grouped GEMM backward: dX = dY w^T and
    dW = x^T dY.  dY, x and w read once, dX and dW written once; twice the
    forward's products."""
    nbytes = (rows * f + rows * d + e * d * f      # read
              + rows * d + e * d * f) * itemsize    # written
    return nbytes, 4 * rows * d * f


def wkv_work(bh, s, d, itemsize, *, backward):
    """``(bytes, flops)`` of the WKV recurrence on [BH,S,D] inputs: bytes of
    r, k, v (``itemsize``), f32 logw, u (and for the backward f32 g in,
    gr/gk/gv out in r's dtype, f32 glogw, gu out) against its operations:
    per step 4*D^2 forward (r.S and the state update), 12*D^2 backward
    (the state rebuilt, q = S g, the G recurrence, p = G v, G^T k and the
    glogw reduction)."""
    n = bh * s * d
    if backward:
        nbytes = (3 * n * itemsize + 2 * n * 4 + bh * d * 4     # in
                  + 3 * n * itemsize + n * 4 + bh * d * 4)    # out
        return nbytes, 12 * bh * s * d * d
    return 3 * n * itemsize + n * 4 + bh * d * 4 + n * 4, 4 * bh * s * d * d


# The rate each kernel's operations are held to: flash and the grouped GEMM
# run bf16 operands on the tensor cores; the WKV kernels' ``mma`` variant
# runs its products with TF32 operands (chip_smoke.py's ``wkv_bound_ms``).
KERNEL_RATE = {"flash": "bfloat16", "moe_gemm": "bfloat16", "wkv": "tf32"}


def call_bound_s(kernel: str, phase: str, shape: dict) -> float:
    """Least time of one recorded call (``OpSpans`` records ``shape``)."""
    it = shape["itemsize"]
    if kernel == "flash":
        args = (shape["b"], shape["hq"], shape["hkv"], shape["s"],
                shape["s"], shape["d"], it)
        kw = {"causal": True, "window": shape["window"]}
        w = attention_fwd_work(*args, **kw) if phase == "fwd" \
            else attention_bwd_work(*args, **kw)
    elif kernel == "moe_gemm":
        args = (shape["e"], shape["rows"], shape["d"], shape["f"], it)
        w = gemm_fwd_work(*args) if phase == "fwd" else gemm_bwd_work(*args)
    elif kernel == "wkv":
        w = wkv_work(shape["bh"], shape["s"], shape["d"], it,
                     backward=phase == "bwd")
    else:
        raise KeyError(kernel)
    return bound_s(*w, KERNEL_RATE[kernel])


def roofline_share(run, kernel: str):
    """Percent of a kernel's least time over its device time in the traced
    session: every call of it recorded there (forwards, recomputes and
    backwards) against the device time of the kernels launched inside its
    spans.  None where the session holds no call of it."""
    if run.session is None:
        return None
    calls = [(ph, sh) for k, ph, sh in run.calls if k == kernel]
    spent = sum(s for (k, _), s in run.session.span_s.items() if k == kernel)
    if not calls or spent <= 0:
        return None
    return 100 * sum(call_bound_s(kernel, ph, sh) for ph, sh in calls) / spent
