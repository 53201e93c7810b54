"""Rank 0's NCCL kernel time that no other kernel overlaps, over its
traced window, in %: the time its card spends only on the gradient sums
that the trainer marks as ``train/allreduce`` spans (None when the trace
has no such span)."""

from port_bench import span_readers


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def read(rec):
    s = rec["trace"]
    if s["window_s"] <= 0 or not any(
            name == "train/allreduce" for _, _, name in s["host_spans"]):
        return None
    nccl, compute = [], []
    for lo, hi, name in s["device"]:
        if "nccl" in name.lower():
            nccl.append((lo, hi))
        elif not name.startswith(("Memcpy", "Memset")):
            compute.append((lo, hi))
    nccl = _union(nccl)
    total = sum(hi - lo for lo, hi in nccl)
    exposed = total - span_readers._overlap(nccl, _union(compute))
    return 100.0 * exposed * 1e-6 / s["window_s"]
