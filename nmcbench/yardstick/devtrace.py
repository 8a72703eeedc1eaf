"""Reduction of one torch.profiler window to the device's busy time, its
kernels by time and its idle gaps by the stage the host had open.

`device_busy` is a frozen copy of the arithmetic of
nmcfluid_torch/tools_walk_roofline.py::device_busy: the sum of the
kernels' own device time from `key_averages()` (overlaps counted twice;
the program runs on one stream). `reduce_events` reads the same window's
raw events once, for the breakdown and the gaps."""
import bisect

NOT_MEASURED = "not measured"


def device_busy(prof):
    """(busy ms, kernels) of a finished profiler window `prof`, or
    (NOT_MEASURED, NOT_MEASURED) when it recorded no device time."""
    from torch.autograd import DeviceType
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            n += e.count
    return (us / 1e3, n) if us > 0.0 else (NOT_MEASURED, NOT_MEASURED)


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return f()
    return getattr(ev, what + "_us")() * 1000


def raw_events(prof):
    """(kernels, ranges): the device's operations as (start ns, end ns,
    name) and the host's stage ranges (record_function "stage:<name>") as
    (start ns, end ns, name), from the profiler's own event list. The
    profiler mirrors each user range on the device's timeline; those
    mirrors are not operations and are left out."""
    from torch.autograd import DeviceType
    kernels, ranges = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        name = ev.name()
        if name.startswith("stage:"):
            # the host's range, and its mirror on the device's timeline
            # (a user annotation, not an operation)
            if ev.device_type() != DeviceType.CUDA:
                ranges.append((start, end, name[6:]))
        elif ev.device_type() == DeviceType.CUDA:
            kernels.append((start, end, name))
    return kernels, ranges


def reduce_events(kernels, ranges, top=10):
    """From raw_events' lists: the busy seconds (the kernels' summed own
    time, as device_busy), the top kernels by summed time [name, s], and
    the idle time between kernels summed by the stage whose host range
    holds each gap's middle [stage (gaps), s], largest first."""
    kernels = sorted(kernels)
    by_name, busy = {}, 0.0
    for s, e, name in kernels:
        d = (e - s) * 1e-9
        busy += d
        by_name[name] = by_name.get(name, 0.0) + d
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    gaps, counts = {}, {}
    reach = kernels[0][1] if kernels else 0
    for s, e, _ in kernels[1:]:
        if s > reach:
            mid = (reach + s) // 2
            i = bisect.bisect_right(starts, mid) - 1
            # the innermost open range: the latest start that still holds
            # the middle
            label = "no stage"
            while i >= 0:
                if ranges[i][1] >= mid:
                    label = ranges[i][2]
                    break
                i -= 1
            gaps[label] = gaps.get(label, 0.0) + (s - reach) * 1e-9
            counts[label] = counts.get(label, 0) + 1
        reach = max(reach, e)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(((f"{k} ({counts[k]} gaps)", v) for k, v in gaps.items()),
                  key=lambda kv: -kv[1])[:top]
    return busy, [[k, v] for k, v in ops], [[k, v] for k, v in idle]
