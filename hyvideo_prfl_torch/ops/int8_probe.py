"""The int8 tensor-core rate probes P1 and P2 (hyvideo_prfl_tpu
scripts/probe_int8_rate.py and scripts/probe_int8_mosaic.py).

Both compute

    out = sum over reps r and b-blocks nb of a @ b_nb^T

with a [M, K] and bt [nblocks * n_cols, K] (b stored transposed, K
contiguous, the layout wgmma reads), int8 -> int32 or bf16 -> fp32. P1
(``probe_rate``) is the TPU grid (reps, nblocks) at its two shapes; P2
(``probe_chain``) is ``steps`` chained products of one pair (nblocks = 1).
On a CUDA tensor both launch csrc/int8_probe.cu (wgmma, the reps split
over a thread-block cluster); the plain versions below are exact integer
arithmetic: int64 on the CPU and fp64 on the card (every value is an
integer far inside fp64's 2^53).
"""

from __future__ import annotations

import statistics

import torch

from . import _build


def probe_plain(a, bt, nblocks: int, reps: int):
    """reps * (a @ (sum over nb of b_nb)^T), exactly: int64 on the CPU,
    fp64 elsewhere. Returns [M, n_cols] in that type."""
    acc = torch.int64 if a.device.type == "cpu" else torch.float64
    k = a.shape[1]
    bsum = bt.to(acc).reshape(nblocks, -1, k).sum(dim=0)
    return (a.to(acc) @ bsum.t()) * reps


def cluster_size(a, n_cols: int, reps: int) -> int:
    """The blocks of one thread-block cluster that share an output tile's
    reps in a probe call on ``a``'s shapes (1 to 8)."""
    m, k = a.shape
    c = _build.lib().hyv_probe_cluster(m, k * a.element_size(), n_cols, reps,
                                       int(a.dtype == torch.int8))
    _build.require(c > 0, f"the probe's cluster size query failed: cudaError {-c}")
    return c


def _launch(entry: str, name: str, a, bt, n_cols: int, nblocks: int, reps: int):
    m, k = a.shape
    _build.require(a.device.type == "cuda" and bt.device == a.device,
                   "a and bt must be on one CUDA device")
    _build.require(a.dtype in (torch.int8, torch.bfloat16) and bt.dtype == a.dtype,
                   f"the probes take int8 or bf16 a and bt, got {a.dtype} and {bt.dtype}")
    _build.require(bt.shape == (nblocks * n_cols, k),
                   f"bt must be [{nblocks * n_cols}, {k}], got {tuple(bt.shape)}")
    _build.require(a.is_contiguous() and bt.is_contiguous() and _build.aligned16(a, bt),
                   "a and bt must be contiguous and 16-byte aligned")
    k_bytes = k * a.element_size()
    _build.require(m % 64 == 0 and n_cols % 128 == 0 and k_bytes % 128 == 0,
                   f"the probe tiles take M % 64, n_cols % 128 and K bytes % 128 == 0; "
                   f"got {m}, {n_cols}, {k_bytes}")
    int8 = a.dtype == torch.int8
    # every element is written once: no zeroing
    out = torch.empty((m, n_cols), dtype=torch.int32 if int8 else torch.float32,
                      device=a.device)
    fn = getattr(_build.lib(), entry)
    if entry == "hyv_probe_rate":
        err = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, k_bytes, n_cols, nblocks,
                 reps, int(int8), _build.stream_ptr(a.device))
    else:
        err = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, k_bytes, n_cols, reps,
                 int(int8), _build.stream_ptr(a.device))
    _build.check(err, name)
    return out


def probe_rate(a, bt, nblocks: int, reps: int):
    """P1: the grid (reps, nblocks) of a @ b_nb^T into one output, on the
    card (or its plain version for a CPU tensor)."""
    if a.device.type == "cpu":
        return probe_plain(a, bt, nblocks, reps)
    return _launch("hyv_probe_rate", "P1", a, bt, bt.shape[0] // nblocks, nblocks, reps)


def probe_chain(a, bt, steps: int):
    """P2: ``steps`` chained products a @ bt^T into one output, on the card
    (or its plain version for a CPU tensor)."""
    if a.device.type == "cpu":
        return probe_plain(a, bt, 1, steps)
    return _launch("hyv_probe_chain", "P2", a, bt, bt.shape[0], 1, steps)


def ternary(shape, generator, device):
    """Probe operands: values -1, 0 and 1, so every partial sum of the
    probes' shapes stays an integer far below 2^24 and the fp32 (bf16
    variant) sums are exact in any order. Returns (int8, bf16) copies."""
    x = torch.randint(-1, 2, shape, generator=generator, device=device, dtype=torch.int8)
    return x, x.to(torch.bfloat16)


def _ms(fn, reps: int = 3) -> float:
    """Median device ms of one call of fn, after a warm-up. Each turn queues
    ``calls`` back-to-back calls behind a device sleep and times them
    between CUDA events, so the host's launch cost stays out of the time
    (a P2 call takes microseconds, less than its wrapper's host work)."""
    fn()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize()
    calls = 1 if ev0.elapsed_time(ev1) > 1.0 else 20
    times = []
    for _ in range(reps):
        torch.cuda._sleep(5_000_000)  # some ms of device time: the calls queue behind it
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(calls):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1) / calls)
    return statistics.median(times)


def measure(tag: str, shape, kernel, generator) -> dict:
    """One probe at one shape (m, k, n_cols, nblocks, reps) on the card, for
    int8 and bf16 operands holding the same ternary values: whether
    ``kernel(a, bt)`` equals the plain version exactly, its ms and TOPS,
    and the library's rate for the product of one rep (torch._int_mm for
    int8, torch.matmul for bf16)."""
    m, k, n_cols, nblocks, reps = shape
    dev = generator.device
    a8, a16 = ternary((m, k), generator, dev)
    b8, b16 = ternary((nblocks * n_cols, k), generator, dev)
    ref = probe_plain(a8, b8, nblocks, reps)
    # every partial sum the kernel forms is at most this in magnitude
    partial = probe_plain(a8.abs(), b8.abs(), nblocks, reps).max().item()
    if partial >= 2 ** 24:
        raise RuntimeError(f"{tag}: partial sums up to {partial:.0f} are not exact in fp32")
    ops = 2.0 * m * k * n_cols * nblocks * reps
    lib_ops = 2.0 * m * k * n_cols * nblocks
    out = {"probe": tag, "m": m, "k": k, "n_cols": n_cols, "nblocks": nblocks, "reps": reps,
           "max_partial_sum": partial, "cluster": cluster_size(a8, n_cols, reps)}
    for name, a, bt, library in (("int8", a8, b8, lambda: torch._int_mm(a8, b8.t())),
                                 ("bf16", a16, b16, lambda: torch.matmul(a16, b16.t()))):
        out[f"{name}_exact"] = bool(torch.equal(kernel(a, bt).double(), ref.double()))
        ms = _ms(lambda: kernel(a, bt))
        out[f"{name}_ms"] = ms
        out[f"{name}_tops"] = ops / (ms * 1e9)
        out[f"{name}_library_tops"] = lib_ops / (_ms(library) * 1e9)
    out["plain_ms"] = _ms(lambda: probe_plain(a8, b8, nblocks, reps))
    out["int8_over_bf16"] = out["bf16_ms"] / out["int8_ms"]
    return out
