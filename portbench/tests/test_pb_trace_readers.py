"""The readers of the program's spans and counters (utils/trace.py in the
port) on a window's numbers and on a program without them, and the
breakdown's idle-gap label when flat `pansvr.*` ranges cover a gap."""

import types

import pytest

from portbench import harness, registry

WINDOW = dict(source_s=4.0, pin_s=0.4, emit_s=2.0, bam_write_s=1.2,
              prep_cpu_s=12.0, main_traced_s=38.0)
TOTAL = dict(engine_build=6.5, index_upload=1.5, engine_rss_gib=2.25,
             rss_built_gib=5.5, rss_peak_gib=5.75)
WANT = dict(source_pct=10.0, pin_pct=1.0, emit_pct=5.0, bam_write_pct=3.0,
            prep_cpu_pct=30.0, main_untraced_pct=5.0, engine_build_s=5.0,
            engine_rss_gib=2.25, stream_rss_gib=0.25)
# the counter each reader needs, in the window's delta or the run's total
NEEDS = dict(source_pct=("prof", "source_s"), pin_pct=("prof", "pin_s"),
             emit_pct=("prof", "emit_s"),
             bam_write_pct=("prof", "bam_write_s"),
             prep_cpu_pct=("prof", "prep_cpu_s"),
             main_untraced_pct=("prof", "main_traced_s"),
             engine_build_s=("prof_total", "engine_build"),
             engine_rss_gib=("prof_total", "engine_rss_gib"),
             stream_rss_gib=("prof_total", "rss_peak_gib"))


def _ctx(prof=WINDOW, total=TOTAL):
    return dict(window_s=40.0, prof=dict(prof), prof_total=dict(total))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_window(name):
    assert registry.metric_reader(name)(_ctx()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(NEEDS))
def test_reader_without_its_counter_reads_nothing(name):
    where, key = NEEDS[name]
    prof, total = dict(WINDOW), dict(TOTAL)
    (prof if where == "prof" else total).pop(key)
    assert registry.metric_reader(name)(_ctx(prof, total)) is None
    # a program with the counter at 0 reads a number
    (prof if where == "prof" else total)[key] = 0.0
    assert registry.metric_reader(name)(_ctx(prof, total)) is not None


def test_gap_is_labelled_by_the_span_that_covers_it():
    """A device gap from 100 to 1,000 us under flat main-thread ranges
    (pansvr.prep_wait over most of it, then pansvr.pin) and an aten op
    that touches it: the label is the range with the largest overlap,
    and the aten op names it no more."""
    from torch.autograd import DeviceType

    def ev(name, a, b, dev=DeviceType.CPU):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(start=a, end=b))

    evs = [ev("kernel_a", 0, 100, DeviceType.CUDA),
           ev("kernel_b", 1000, 1100, DeviceType.CUDA),
           ev("aten::pin_memory", 90, 110),
           ev("pansvr.prep_wait", 110, 800),
           ev("pansvr.pin", 800, 1000)]
    prof = types.SimpleNamespace(events=lambda: evs)
    _, _, _, idle = harness.device_breakdown(prof)
    assert idle == [["pansvr.prep_wait", pytest.approx(900e-6)]]
    evs[3:] = [ev("pansvr.prep_wait", 110, 300), ev("pansvr.pin", 300, 1000)]
    _, _, _, idle = harness.device_breakdown(prof)
    assert idle == [["pansvr.pin", pytest.approx(900e-6)]]
