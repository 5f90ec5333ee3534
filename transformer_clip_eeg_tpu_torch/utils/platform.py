"""Host memory helpers of the cross-validation driver.

The torch package's own copy of ``trim_host_heap``, ``host_rss_gb`` and
``host_mem_total_gb`` from ``transformer_clip_eeg_tpu/utils/platform.py``
(that module's other helpers configure JAX and have no torch meaning).
``cv.py`` trims the heap after the per-fold evaluation suites and reads the
resident set against the memory the process may use.
"""

from __future__ import annotations

import ctypes
import os

_CGROUP_LIMITS = (
    "/sys/fs/cgroup/memory.max",                    # cgroup v2
    "/sys/fs/cgroup/memory/memory.limit_in_bytes",  # cgroup v1
)


def trim_host_heap() -> None:
    """Return freed glibc heap pages to the OS (``malloc_trim``).

    The per-fold evaluation suites allocate and free many arrays of about
    10 MB; glibc's dynamic mmap threshold moves such sizes onto the sbrk
    heap, whose freed pages the allocator keeps.  A trim after each fold's
    suite keeps the resident set at the working set.  No-op where there is
    no glibc."""
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def host_rss_gb() -> float:
    """The process's resident set now, in GiB (0.0 where ``/proc`` is
    absent): ``/proc/self/statm``, not ``ru_maxrss``, a high-water mark that
    cannot show a trim lowering the resident set."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30
    except (OSError, ValueError, IndexError):
        return 0.0


def host_mem_total_gb() -> float:
    """The memory this process may use, in GiB (0.0 if unknowable): the
    least of physical memory and a cgroup limit, so that a guard sized from
    it fires inside a container capped below the machine's memory."""
    limits = []
    try:
        limits.append(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 2**30)
    except (OSError, ValueError):
        pass
    for path in _CGROUP_LIMITS:
        try:
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            continue
        if raw == "max":
            continue
        try:
            val = int(raw) / 2**30
        except ValueError:
            continue
        # cgroup v1 writes "no limit" as a huge page-rounded number; a real
        # cap is below about 1 PiB
        if 0 < val < 2**20:
            limits.append(val)
    limits = [v for v in limits if v]
    return min(limits) if limits else 0.0
