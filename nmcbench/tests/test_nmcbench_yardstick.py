"""The benchmark's frozen yardstick gives today the numbers of the port's
own functions it was copied from, at both configurations' shapes."""
from types import SimpleNamespace

import pytest
import torch

from nmcbench import run as R
from nmcbench.yardstick import devtrace, peaks, work


@pytest.mark.parametrize("config", ["taylorgreen", "smoke"])
def test_iteration_work_matches_the_port(config):
    from nmcfluid_torch.models.siren import SirenConfig
    from nmcfluid_torch.sim.fitkernel import iteration_work
    cfg = R.load_json(R.HERE, "configs", config + ".json")
    d_in, d_out, h, lh = work.net_shape(cfg)
    B = cfg["scene_fields"]["sample_resolution"] ** 2
    port = iteration_work(SirenConfig(d_in, d_out, num_hidden_layers=lh,
                                      hidden_features=h), B)
    assert work.iteration_work(d_in, d_out, h, lh, B) == port


@pytest.mark.parametrize("config", ["taylorgreen", "smoke"])
def test_bound_ms_matches_the_port(config):
    from nmcfluid_torch.utils import h100
    cfg = R.load_json(R.HERE, "configs", config + ".json")
    b, f = work.fit_work(cfg)
    assert peaks.bound_ms(b, f) == h100.bound_ms(b, f)
    assert (peaks.HBM_BYTES_PER_S, peaks.F32_FLOPS, peaks.TF32_FLOPS) == (
        h100.HBM_BYTES_PER_S, h100.F32_FLOPS, h100.TF32_FLOPS)


class _FakeProfile:
    """A torch.profiler.profile stand-in whose key_averages() are fixed
    events: two CUDA kernels and a CPU op."""

    def __init__(self, *a, **k):
        from torch.autograd import DeviceType
        self.events = [
            SimpleNamespace(device_type=DeviceType.CUDA,
                            self_device_time_total=1250.5, count=3),
            SimpleNamespace(device_type=DeviceType.CUDA,
                            self_device_time_total=80.25, count=7),
            SimpleNamespace(device_type=DeviceType.CPU,
                            self_device_time_total=999.0, count=1)]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def key_averages(self):
        return self.events


def test_device_busy_matches_the_port(monkeypatch):
    import torch.profiler
    from nmcfluid_torch import tools_walk_roofline as twr
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(twr, "_sync", lambda dev: None)
    port = twr.device_busy(lambda: None, torch.device("cuda"))
    assert devtrace.device_busy(_FakeProfile()) == port
    assert port == (1330.75 / 1e3, 10)


def test_reduce_events_sums_kernels_and_labels_gaps():
    kernels = [(0, 10, "a"), (15, 20, "b"), (40, 50, "a")]
    ranges = [(0, 30, "advect_fit"), (30, 60, "div_grid")]
    busy, ops, gaps = devtrace.reduce_events(kernels, ranges)
    assert busy == pytest.approx(25e-9)
    assert ops == [["a", pytest.approx(20e-9)], ["b", pytest.approx(5e-9)]]
    # gap 10-15 (middle 12) in advect_fit, gap 20-40 (middle 30) in div_grid
    assert dict(gaps) == {"div_grid (1 gaps)": pytest.approx(20e-9),
                          "advect_fit (1 gaps)": pytest.approx(5e-9)}


def test_frame_flops_counts_the_fits_first():
    cfg = R.load_json(R.HERE, "configs", "taylorgreen.json")
    fits = work.fit_work(cfg)[1]
    total = work.frame_flops(cfg)
    assert fits < total < 1.2 * fits


class _Ev:
    def __init__(self, name, cuda, start, dur):
        from torch.autograd import DeviceType
        self._n, self._s, self._d = name, start, dur
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_raw_events_leave_out_the_ranges_mirrored_on_the_device():
    events = [_Ev("stage:walk", False, 0, 100), _Ev("stage:walk", True, 0,
                                                    100),
              _Ev("kernel_a", True, 10, 5), _Ev("aten::add", False, 9, 3)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    kernels, ranges = devtrace.raw_events(prof)
    assert kernels == [(10, 15, "kernel_a")]
    assert ranges == [(0, 100, "walk")]
