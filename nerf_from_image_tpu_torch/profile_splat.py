"""The splat probes P1 and P2 on the card, each against its bound.

    python -m nerf_from_image_tpu_torch.profile_splat

Counterpart of scripts/profile_splat.py (P1: the windowed tent-matrix
splat, seven stages and four more window shapes) and
scripts/profile_splat_io.py (P2: launch, g-streaming and
coordinate-streaming floors), on the kernels of csrc/splat_probes.cu. The
inputs are made as those scripts make them: numpy default_rng(0), the same
draws in the same order, B=4, H=W=256, C=32, N=128*128*64 points per batch
element in blocks of P.

Each case prints its time per call in two ways: `ms`, the median of
DEVICE_ITERS calls each timed alone at cold L2 with the host out of the
way (`device_ms`), and `old_method_ms`, the mean of 5 calls launched back
to back from Python between one pair of CUDA events at warm L2
(`cuda_ms`); both include whatever the wrapper launches (P1's wrapper
zeroes its output first). Beside them: the device activities of one
call and the time of its last one, the kernel itself (`call_activities`),
its bound (the larger of the bytes it must move over the memory rate and
the operations its output needs over the card's peak rate), the share of
the bound reached, for P1 the time of its dense formulation's operations
at peak rate, and for P2 the zeroing of the output alone (`zero_ms`) and
the library call, both timed the two ways. The last line is one JSON
object with every case.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Dict, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.kernels.splat_probes import (
    EMPTY_COLS,
    EMPTY_ROWS,
    IO_VARIANTS,
    STAGES,
    _tents,
    _window_operand,
    splat_io_probe,
    splat_io_probe_reference,
    splat_window_probe,
    splat_window_probe_reference,
)
from nerf_from_image_tpu_torch.utils.device import resolve_device

B, H, W, C = 4, 256, 256, 32
N = 128 * 128 * 64  # points per batch element

# H100 SXM data-sheet peaks at 700 W: HBM3, dense bf16 on the tensor
# cores, f32 outside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
TENT_OPS = 4  # two subtractions, 1 - |d|, max(0, .)
# device_ms: calls timed one by one, each after writing FLUSH_BYTES (five
# times the 50 MB L2) and reading CLEAN_BYTES of another buffer, then a
# device-side spin of SLEEP_CYCLES clocks (~0.5 ms at 1.98 GHz) while the
# host enqueues the call.
DEVICE_ITERS = 20
FLUSH_BYTES = 256 << 20
CLEAN_BYTES = 64 << 20
SLEEP_CYCLES = 1 << 20
# Profiler sessions call_activities takes before it gives up: on the card
# a trace can lose a session's first device activities, up to all of them.
ACTIVITY_SESSIONS = 3


@dataclasses.dataclass(frozen=True)
class Case:
    """One timed probe: P1 ('window', with its window WY x WX) or P2 ('io')."""

    probe: str
    variant: str  # a P1 stage or a P2 variant
    P: int
    WY: int = 0
    WX: int = 0

    @property
    def name(self) -> str:
        if self.probe == "window":
            return (f"splat_window_probe[{self.variant},P={self.P},"
                    f"WY={self.WY},WX={self.WX}]")
        return f"splat_io_probe[{self.variant},P={self.P}]"


# The lists of the two scripts' main().
CASES = (
    [Case("window", s, 1024, 64, 64) for s in STAGES]
    + [Case("window", "full", 1024, 64, 48), Case("window", "bf16build", 1024, 64, 48),
       Case("window", "bf16build", 1024, 64, 32), Case("window", "bf16build", 2048, 64, 64),
       Case("window", "bf16build", 2048, 128, 64)]
    + [Case("io", v, 1024) for v in IO_VARIANTS]
    + [Case("io", "read_ixy_P1", 4096), Case("io", "empty", 4096)]
)


# P2 at the edges of its launch plan (B, nblocks, P, H, W), beside the
# cases above; on 132 SMs: CTA ranges that cross batch boundaries (333
# blocks a batch element, 6 a CTA); nblocks not a multiple of the CTA
# count (530 blocks, 3 a CTA, 2 in the last); B=1 with a single block; and
# P=64 at the scripts' full shape (249 blocks a CTA, both of the above).
IO_EDGE_SHAPES = ((4, 333, 64, 32, 32), (1, 530, 64, 32, 32), (1, 1, 64, 32, 32),
                  (B, N // 64, 64, H, W))


class ProbeInputs:
    """The scripts' inputs on one device, drawn once per block size P."""

    def __init__(self, device, b=B, h=H, w=W, n=N):
        self.device = torch.device(device)
        self.B, self.H, self.W, self.N = b, h, w, n
        self._points: Dict[int, Tuple] = {}

    def points(self, P: int):
        """(iy, ix [B, nblocks, P] f32, ixy [B, nblocks, 2, P] f32, g
        [B, nblocks, P, C] bf16, the generator's state after g)."""
        if P not in self._points:
            nb = self.B * (self.N // P)
            rng = np.random.default_rng(0)
            iy = rng.uniform(0, self.H - 1, (nb, P)).astype(np.float32)
            ix = rng.uniform(0, self.W - 1, (nb, P)).astype(np.float32)
            g = rng.standard_normal((nb, P, C)).astype(np.float32)
            shape = (self.B, nb // self.B, P)
            to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            tiy, tix = to(iy).reshape(shape), to(ix).reshape(shape)
            tg = to(g).to(torch.bfloat16).reshape(*shape, C)
            del g
            ixy = torch.stack((tiy, tix), dim=2).contiguous()
            self._points[P] = (tiy, tix, ixy, tg, rng.bit_generator.state)
        return self._points[P]

    def windows(self, P: int, WY: int, WX: int):
        """(oy0, ox0) [B, nblocks] i32: the scripts' draws after g."""
        iy = self.points(P)[0]
        rng = np.random.default_rng(0)
        rng.bit_generator.state = self.points(P)[4]
        nb = iy.shape[0] * iy.shape[1]
        oy0 = rng.integers(0, (self.H - WY) // 8, nb).astype(np.int32) * 8
        ox0 = rng.integers(0, (self.W - WX) // 4, nb).astype(np.int32) * 4
        return tuple(torch.from_numpy(a).to(self.device).reshape(iy.shape[:2])
                     for a in (oy0, ox0))

    def args(self, case: Case):
        """The wrapper's (and the plain version's) positional arguments."""
        iy, ix, ixy, g, _ = self.points(case.P)
        if case.probe == "window":
            oy0, ox0 = self.windows(case.P, case.WY, case.WX)
            return (oy0, ox0, iy, ix, g, self.H, self.W, case.WY, case.WX, case.variant)
        return (case.variant, iy, ix, ixy, g, self.H, self.W)


def kernel_fn(case: Case):
    return splat_window_probe if case.probe == "window" else splat_io_probe


def plain_fn(case: Case):
    return (splat_window_probe_reference if case.probe == "window"
            else splat_io_probe_reference)


def _dense_ops(case: Case, points: int):
    """(tensor-core flops, other ops) of P1's dense formulation: every
    tent entry built, the window product over all WY x WX*C entries."""
    v, WY, WXC = case.variant, case.WY, case.WX * C
    tensor, other = 0, 0
    if v != "z_only":
        other += TENT_OPS * points * WY
    if v != "oy_only":
        other += TENT_OPS * points * case.WX + points * WXC  # zx, then Z
    if v == "z_only":
        other += points * WXC  # the column sums
    elif v == "oy_only":
        tensor = 2 * points * WY * WY
    else:
        tensor = 2 * points * WY * WXC
        if v == "dottile":
            tensor += 2 * points * C * WXC
        if v == "no_tile":
            other -= points * WXC  # Z is zx itself
    return tensor, other


def bound(case: Case, b=B, h=H, w=W, n=N) -> dict:
    """The least time of one call of `case`: the larger of its bytes (each
    input read once, the [B, H, W*C] f32 output written once) over the
    memory rate and the operations its output needs over the f32 rate.

    A point's tents are nonzero on 2 rows and 2 x-positions, so P1's output
    needs per point: 2 + 2 tents, 4 weights and 4 x 32 multiply-adds (oy_only
    4 products; z_only 2 tents and 2 x 32). P1's kernels compute the dense
    formulation instead, every tent entry and the whole window product:
    `dense_product_ms` is that work over the bf16 tensor-core rate (the
    product) and the f32 rate (the rest), whichever is longer; None for P2.
    P2's `empty` does one add per block and corner element.
    """
    points = b * n
    coord = 4 * points  # one f32 coordinate array
    g_bytes = 2 * points * C
    out = 4 * b * h * w * C
    window_bytes = 2 * 4 * (points // max(case.P, 1))  # oy0, ox0
    dense_ms = None
    if case.probe == "window":
        v = case.variant
        reads = {
            "z_only": coord + g_bytes,
            "oy_only": coord,
            "no_tile": 2 * coord,
        }.get(v, 2 * coord + g_bytes)
        n_bytes = reads + window_bytes + out
        ops = points * {
            "z_only": 2 * TENT_OPS + 2 * C * 2,
            "oy_only": 2 * TENT_OPS + 4 * 2,
        }.get(v, 4 * TENT_OPS + 4 + 4 * C * 2)
        tensor, other = _dense_ops(case, points)
        dense_ms = max(tensor / PEAK_BF16_FLOPS, other / PEAK_F32_FLOPS) * 1e3
    else:
        reads = {"empty": 0, "read_g": g_bytes, "transpose_2P": 2 * coord}.get(
            case.variant, 2 * coord)
        n_bytes = reads + out
        ops = points * {
            "empty": 0,  # below: one add per block and corner element
            "read_g": C,
            "read_ixy_P1": 2,
            "read_ixy_2P": 2,
            "transpose_2P": 2 * (TENT_OPS + 2),  # the 2 nonzero lanes: + 0*ix, sum
        }[case.variant]
        if case.variant == "empty":
            ops = points // case.P * min(h, EMPTY_ROWS) * min(w * C, EMPTY_COLS)
    times = {
        "bytes": n_bytes / PEAK_BYTES_PER_S * 1e3,
        "operations": ops / PEAK_F32_FLOPS * 1e3,
    }
    by = max(times, key=times.get)
    return {"bytes": n_bytes, "ops": ops, "bound_ms": times[by], "bound_by": by,
            "dense_product_ms": dense_ms}


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters` calls
    launched back to back from Python (warm L2; for a short kernel the
    host's launch path can set the pace)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _cold_buffers() -> Tuple[torch.Tensor, torch.Tensor]:
    """The flush and clean buffers of `_cold_preamble`, made by each
    measurement and freed with it."""
    return (torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda"),
            torch.ones(CLEAN_BYTES // 4, dtype=torch.float32, device="cuda"))


def _cold_preamble(buffers, cycles: int) -> None:
    """Evicts the next call's data from L2 and holds the stream back:
    writes FLUSH_BYTES, then reads CLEAN_BYTES of another buffer, so that
    L2 holds clean lines of neither the call nor the flush and the call
    pays no write-back of the flush, then spins `cycles` clocks on the
    device while the host enqueues the call."""
    flush, clean = buffers
    flush.fill_(1.0)
    clean.sum()
    torch.cuda._sleep(cycles)


def device_ms(fn, iters: int = DEVICE_ITERS) -> float:
    """Median device time of one fn() call in ms, with the host out of the
    way: each call runs after `_cold_preamble` (cold L2, the call queued
    behind a device-side spin) between its own pair of CUDA events. If the
    device reaches a call's first event before the host has queued the
    call, the spin doubles and the calls are timed again."""
    buffers = _cold_buffers()
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    while True:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        late = 0
        for start, end in pairs:
            _cold_preamble(buffers, cycles)
            start.record()
            fn()
            end.record()
            late += start.query()
        torch.cuda.synchronize()
        if not late:
            return float(np.median([s.elapsed_time(e) for s, e in pairs]))
        if cycles >= 64 * SLEEP_CYCLES:
            raise RuntimeError("device_ms: the host fell behind a spin of "
                               f"{cycles} clocks")
        cycles *= 2


def _device_events(prof):
    """(start us, name, duration us) of every device activity traced."""
    return sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                  for e in prof.events() if str(e.device_type).endswith("CUDA"))


def call_activities(fn, iters: int = 3):
    """The device activities (kernels, memsets) of `iters` calls of fn,
    each after `_cold_preamble`, from torch.profiler: (calls, discarded).
    `calls` holds one list per call of (name, duration in us), in stream
    order. A call's activities are those after its preamble's spin kernel;
    every call must show the same names (a trace may drop the first
    activity of a session, so the calls are found from the spins and the
    last call's length, not from counts). A session whose trace cannot be
    split so is traced again, up to ACTIVITY_SESSIONS sessions in all;
    `discarded` lists the activity names of each session set aside."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    buffers = _cold_buffers()  # made outside the trace
    fn()
    torch.cuda.synchronize()
    discarded = []
    while len(discarded) < ACTIVITY_SESSIONS:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                _cold_preamble(buffers, SLEEP_CYCLES)
                fn()
            torch.cuda.synchronize()
        events = [(name, us) for _, name, us in _device_events(prof)]
        spins = [i for i, (name, _) in enumerate(events) if "spin_kernel" in name]
        last = events[spins[-1] + 1:] if spins else []
        calls = [events[i + 1:i + 1 + len(last)] for i in spins[:-1]] + [last]
        if len(spins) == iters and last and all(
                [n for n, _ in c] == [n for n, _ in last] for c in calls):
            return calls, discarded
        discarded.append([n for n, _ in events])
    raise RuntimeError(f"call_activities: cannot split the device activities of "
                       f"{ACTIVITY_SESSIONS} sessions into {iters} calls: {discarded}")


def zero_ms(inputs: "ProbeInputs") -> dict:
    """The zeroing of a P2 output alone, torch.zeros of [B, H, W * C] f32,
    timed both ways."""
    fn = lambda: torch.zeros((inputs.B, inputs.H, inputs.W * C),  # noqa: E731
                             dtype=torch.float32, device=inputs.device)
    return {"zero_ms": device_ms(fn), "zero_old_method_ms": cuda_ms(fn, iters=5, warmup=2)}


def time_case(case: Case, inputs: ProbeInputs) -> dict:
    """The wrapper's ms per call at the case's full shape, both ways, and
    its device activities: `ms` (device_ms), `old_method_ms` (cuda_ms over
    5 calls), `activities` (names of one call's, in stream order) and
    `kernel_ms` (the median time of a call's last activity, the kernel)
    and `discarded_sessions` (call_activities' sessions set aside)."""
    args = inputs.args(case)
    fn = kernel_fn(case)
    call = lambda: fn(*args)  # noqa: E731
    acts, discarded = call_activities(call)
    return {
        "ms": device_ms(call),
        "old_method_ms": cuda_ms(call, iters=5, warmup=2),
        "activities": [name for name, _ in acts[0]],
        "kernel_ms": float(np.median([a[-1][1] for a in acts])) / 1e3,
        "discarded_sessions": discarded,
    }


def window_bmm_operands(inputs: ProbeInputs, case: Case):
    """oy^T [NB, WY, P] and Z [NB, P, WX*C] bf16 of every block (Z None for
    oy_only): the operands of the case's window products, for the library
    call (the timing yardstick; the port never calls it)."""
    oy0, ox0, iy, ix, g = inputs.args(case)[:5]
    nb, P = iy.shape[0] * iy.shape[1], case.P
    flat = [t.reshape(nb, *t.shape[2:]) for t in (oy0, ox0, iy, ix, g)]
    lhs = torch.empty((nb, case.WY, P), dtype=torch.bfloat16, device=iy.device)
    rhs = None
    if case.variant != "oy_only":
        rhs = torch.empty((nb, P, case.WX * C), dtype=torch.bfloat16, device=iy.device)
    step = 256
    for s in range(0, nb, step):
        oy, zx = _tents(*(t[s:s + step] for t in flat[:4]), inputs.H, inputs.W,
                        case.WY, case.WX, case.variant)
        lhs[s:s + step] = oy.transpose(1, 2)
        if rhs is not None:
            rhs[s:s + step] = _window_operand(zx, flat[4][s:s + step], case.variant)
    return lhs, rhs


def library_call(case: Case, inputs: ProbeInputs):
    """One PyTorch call computing the case's work from prepared operands,
    or None where no single call does:

        P1 z_only:       the column sums of Z over each batch element's points
        P1 oy_only:      torch.bmm(oy^T, oy) over the blocks
        P1, other stages: torch.bmm(oy^T, Z) over the blocks (the window
                         products without their scatter into the plane)
        P2 read_g:       g.sum over the points; read_ixy_P1 and
                         read_ixy_2P: ixy.sum (the same sum from the
                         stacked coordinates); transpose_2P: ixy's
                         [2, P] blocks transposed, .contiguous()
    """
    if case.probe == "window":
        lhs, rhs = window_bmm_operands(inputs, case)
        if case.variant == "z_only":
            rows = rhs.view(inputs.B, -1, rhs.shape[-1])
            return lambda: rows.sum(dim=1, dtype=torch.float32)
        if case.variant == "oy_only":
            return lambda: torch.bmm(lhs, lhs.transpose(1, 2))
        return lambda: torch.bmm(lhs, rhs)
    _, _, ixy, g, _ = inputs.points(case.P)
    if case.variant == "read_g":
        return lambda: g.sum(dim=(1, 2), dtype=torch.float32)
    if case.variant in ("read_ixy_P1", "read_ixy_2P"):
        return lambda: ixy.sum(dim=(1, 2, 3))
    if case.variant == "transpose_2P":
        return lambda: ixy.transpose(2, 3).contiguous()
    return None


def main() -> None:
    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    inputs = ProbeInputs(dev)
    zero = zero_ms(inputs)
    print(f"  torch.zeros of the [{B}, {H}, {W * C}] f32 output: {zero['zero_ms']:.4f} ms "
          f"(old method {zero['zero_old_method_ms']:.4f} ms)", flush=True)
    rows = []
    for case in CASES:
        t = time_case(case, inputs)
        b = bound(case)
        row = {"name": case.name, **t, **b}
        lib = ""
        if case.probe == "io":
            row.update(zero)
            library = library_call(case, inputs)
            row["library_ms"] = None if library is None else device_ms(library)
            row["library_old_method_ms"] = (None if library is None
                                            else cuda_ms(library, iters=5, warmup=2))
            lib = ("  library none" if library is None else
                   f"  library {row['library_ms']:.4f} (old method "
                   f"{row['library_old_method_ms']:.4f})")
        rows.append(row)
        dense = ("" if b["dense_product_ms"] is None
                 else f"  dense {b['dense_product_ms']:8.4f} ms")
        print(f"  {case.name:48s} {t['ms']:9.4f} ms (old method {t['old_method_ms']:.4f}, "
              f"kernel {t['kernel_ms']:.4f}, {len(t['activities'])} activities, "
              f"{len(t['discarded_sessions'])} profiler sessions discarded)  "
              f"bound {b['bound_ms']:8.4f} ms ({b['bound_by']})  "
              f"{100 * b['bound_ms'] / t['ms']:6.2f}% of bound{dense}{lib}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "cases": rows}))


if __name__ == "__main__":
    main()
