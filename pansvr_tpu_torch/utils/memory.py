"""The process's resident memory by kind of mapping, read from /proc.

`rss_by_kind` reads /proc/self/smaps once and sums each mapping's Rss
into four kinds by the mapping's path:

  anon  no path, or a pseudo-path in brackets ([heap], [stack], ...):
        malloc'd and torch-allocated host memory, pinned blocks among it;
  lib   a shared library (libtorch_cuda.so, libcudnn.so.9, an extension
        module's .so);
  dev   a device file (/dev/...: the CUDA driver's mappings of
        /dev/nvidia*);
  file  any other mapped file (an index store's .npy, a locale archive).

It also gives the libraries with the most resident memory, VmRSS from
/proc/self/status read just after, and its own seconds. `peak_rss_gib`
reads the process's peak RSS so far (ru_maxrss), `vmrss_gib` VmRSS alone
(a few microseconds; `rss_growth` adds its growth across a block to a
counter), `pinned_host` the counters of PyTorch's caching host
allocator. Where /proc is missing the /proc readers return None and
rss_growth adds nothing.
"""

from __future__ import annotations

import contextlib
import re
import resource
import time

GIB = float(1 << 30)
KINDS = ("anon", "lib", "dev", "file")
# ".so" closing the path or followed by a version or " (deleted)"
_LIB = re.compile(r"\.so(?:$|[. ])")


def kind_of(path: str) -> str:
    """The kind (one of KINDS) of a mapping with this path ("" for
    none)."""
    if not path or path.startswith("["):
        return "anon"
    if path.startswith("/dev/"):
        return "dev"
    return "lib" if _LIB.search(path) else "file"


def mappings(text: str):
    """(path, Rss in KiB) of each mapping of an smaps text; path "" for
    a mapping with none."""
    path = ""
    for line in text.splitlines():
        head = line.split(None, 5)
        if not head:
            continue
        if not head[0].endswith(":"):
            # address range, perms, offset, device, inode[, path]
            path = head[5] if len(head) == 6 else ""
        elif head[0] == "Rss:":
            yield path, int(head[1])


def split_rss(text: str, top: int = 8) -> tuple[dict, list]:
    """({kind: GiB} over KINDS, [(library path, GiB)] of the `top`
    libraries with the most Rss, summed over each path's mappings) of an
    smaps text."""
    kinds = dict.fromkeys(KINDS, 0)
    libs: dict[str, int] = {}
    for path, kib in mappings(text):
        k = kind_of(path)
        kinds[k] += kib
        if k == "lib":
            libs[path] = libs.get(path, 0) + kib
    most = sorted(libs.items(), key=lambda x: -x[1])[:top]
    return ({k: v * 1024 / GIB for k, v in kinds.items()},
            [(p, v * 1024 / GIB) for p, v in most])


def peak_rss_gib() -> float:
    """The process's peak RSS so far (ru_maxrss, KiB on Linux), GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / GIB


def vmrss_gib(status: str = "/proc/self/status") -> float | None:
    """The process's resident set now (VmRSS), GiB."""
    try:
        with open(status) as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / GIB
    except OSError:
        pass
    return None


@contextlib.contextmanager
def rss_growth(prof: dict, key: str):
    """Add VmRSS's growth across the block (GiB; below 0 where the
    process shrank meanwhile) to prof[key]."""
    r0 = vmrss_gib()
    yield
    r1 = vmrss_gib()
    if r0 is not None and r1 is not None:
        prof[key] = prof.get(key, 0.0) + r1 - r0


def rss_by_kind(smaps: str = "/proc/self/smaps",
                status: str = "/proc/self/status", top: int = 8
                ) -> dict | None:
    """{"kinds": {kind: GiB}, "top": [(library path, GiB)], "vmrss":
    GiB, "s": the read's seconds} of this process now (split_rss of one
    read of `smaps`, then vmrss_gib)."""
    t = time.perf_counter()
    try:
        with open(smaps) as fh:
            text = fh.read()
    except OSError:
        return None
    kinds, most = split_rss(text, top)
    return dict(kinds=kinds, top=most, vmrss=vmrss_gib(status),
                s=time.perf_counter() - t)


PINNED = ("pinned_host_gib", "pinned_active_peak_gib", "n_pinned_blocks")


def pinned_host() -> dict:
    """PyTorch's caching host allocator now: pinned_host_gib (the bytes
    of the pinned blocks it owns, cached ones included),
    pinned_active_peak_gib (the most ever checked out at once: what a
    pool must hold) and n_pinned_blocks (the blocks it owns); the keys
    this torch's host_memory_stats lacks are left out. Checked-out blocks
    are owned ones, so an active peak above the owned peak is no byte
    count (torch 2.11's active_bytes falls by 1, not by the block's
    bytes, when a block comes back): left out too."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    s = stats() if stats is not None else {}
    if s.get("active_bytes.peak", 0) > s.get("allocated_bytes.peak", 0):
        s.pop("active_bytes.peak")
    out = {}
    for key, name, scale in zip(
            ("allocated_bytes.current", "active_bytes.peak",
             "allocations.current"), PINNED, (GIB, GIB, 1.0)):
        if key in s:
            out[name] = float(s[key]) / scale
    return out
