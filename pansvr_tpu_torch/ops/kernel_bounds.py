"""Kernel times on the card, and the least time the card could take for
the same work (the bound), for chip_smoke.py and scale_run.

K1's bound is the larger of its operations, OPS_PER_CELL lane
instructions a band cell (two cells an instruction in the packed 16-bit
instance) at the SMs' integer issue rate, and its bytes (inputs, 9
scalars and every direction byte) at HBM_BYTES_PER_S. K2's is its bytes:
one SECTOR a diagonal walked plus its ops row and scalars. Both count
the band cells and walks of the inputs at hand, not the most they could
need.
"""

from __future__ import annotations

import subprocess

from .extd2 import plan

# K1's operations a band cell: the adds, the four-way max with its
# direction code, the four gap flags and the band blends of
# csrc/extd2_fwd.cu, each one 32-bit lane instruction; the packed 16-bit
# instance does two cells an instruction (vadd2 / vmins2 / DPX 16x2)
OPS_PER_CELL = 30
# lane instructions a clock an SM: 4 warp instructions issue a clock, and
# the integer ALU pipe (64 lanes) co-issues with the FMA pipe that runs
# IMAD (64 lanes), so no mix of integer instructions goes faster
ISSUE_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
SECTOR = 32                   # bytes the card moves for one scattered read


def int_ops_per_s() -> tuple[float, float]:
    """(integer lane instructions/s, max SM clock in MHz) of card 0: SMs x
    ISSUE_LANES_PER_SM x the maximum SM clock nvidia-smi reads (derived,
    not a published figure)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6, mhz


def bound(ops_s, n_bytes):
    """(least ms, what bounds it) of an ops time and a byte count."""
    b_s = n_bytes / HBM_BYTES_PER_S
    return max(ops_s, b_s) * 1e3, "operations" if ops_s >= b_s else "bytes"


def k1_bound(n_cells, B, Q, T, W, n_diag_pad, packed, int_rate):
    """K1 computes n_cells band cells (two per instruction when packed),
    reads its inputs and writes 9 scalars and every direction byte."""
    return bound(OPS_PER_CELL * n_cells / (2 if packed else 1) / int_rate,
                 B * (Q + T + 2 * 4 + 9 * 4) + B * n_diag_pad * W)


def k2_bound(n, n_steps, n_diag_pad):
    """K2 reads one sector per diagonal it walks and writes its ops row."""
    return bound(0.0, SECTOR * n_steps + n * n_diag_pad + n * (4 * 4 + 2 * 4))


def cuda_ms(fn, reps):
    """Mean ms of fn over reps calls after one warm-up, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def pass_table(samples: dict, launches: dict, int_rate: float,
               reps: int = 20) -> list[dict]:
    """One row per (kernel, Tmax, W, B) a pass launched (`launches`, as
    extd2_cuda.LAUNCHES_BY_SHAPE counts them): its launches, the kernel
    alone on that shape's last launch of the pass (`samples`, from
    extd2_cuda.keep_samples; CUDA events around `reps` raw launches),
    launches x that time, and the bound of those inputs. The band cells
    and walks are counted by the plain versions, which launch nothing."""
    from . import extd2_cuda as ec

    rows = []
    for key, n in sorted(launches.items()):
        kernel, T, W, B = key
        args = samples[key]
        # (q, ql, t, tl, params, W) / (dmat, ql, tl, i0, j0, params, W,
        # n_diag_pad, Tmax)
        params = args[4] if kernel == "extd2_fwd" else args[5]
        row = dict(kernel=kernel, Tmax=T, W=W, B=B, launches=n)
        if kernel == "extd2_fwd":
            Q = args[0].shape[1]
            cells = int(ec.extd2_fwd_plain_cells(*args)[1].sum().item())
            row["kernel_ms"] = cuda_ms(ec.fwd_raw_launcher(*args), reps)
            row["bound_ms"], row["bound_by"] = k1_bound(
                cells, B, Q, T, W, plan(Q, T, W)[1],
                ec.packed_state(params, W), int_rate)
            row.update(Qmax=Q, band_cells=cells)
        else:
            walks = (ec.extd2_traceback_plain(*args)[0] != 3).sum(1)
            row["kernel_ms"] = cuda_ms(ec.tb_raw_launcher(*args), reps)
            row["bound_ms"], row["bound_by"] = k2_bound(
                B, int(walks.sum().item()), args[7])
            row["longest_walk"] = int(walks.max().item())
        row["pass_ms"] = n * row["kernel_ms"]
        rows.append(row)
    return rows


def device_activity(prof, wall_s: float, top: int = 12) -> dict:
    """What a finished torch.profiler run (CPU and CUDA activities) saw
    of the card over a region of wall_s host seconds: busy_s, the union
    of the device intervals of its kernels, copies and sets (kernels in
    a CUDA graph's replay included), idle_share = 1 - busy_s / wall_s,
    the device kernels it ran, the host's CUDA runtime calls by name
    ([count, ms]: cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync,
    ...), and the `top` host operations by their own CPU time ([name,
    count, ms])."""
    from torch.autograd import DeviceType

    spans, kernels, calls = [], 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.name.startswith("cuda"):
            c = calls.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_s = busy_us / 1e6
    host = sorted(((k.key, k.count, k.self_cpu_time_total / 1e3)
                   for k in prof.key_averages()
                   if k.self_cpu_time_total > 0), key=lambda r: -r[2])
    return dict(wall_s=wall_s, busy_s=busy_s,
                idle_share=1 - busy_s / wall_s if wall_s else None,
                kernels=kernels,
                runtime_calls={k: [n, round(ms, 3)]
                               for k, (n, ms) in sorted(calls.items())},
                top_host=[[k, n, round(ms, 3)] for k, n, ms in host[:top]])
