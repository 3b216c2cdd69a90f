"""The readers of the program's host-memory counters (utils/memory.py and
align/engine.py's snapshots in the port) on a run's numbers, and on a
program without them."""

import pytest

from portbench import registry

# the run's totals (the snapshots are levels, not sums: the window's
# delta is not what the readers read)
TOTAL = dict(rss_start_gib=4.125, rss_end_lib_gib=3.25,
             rss_end_anon_gib=1.5, pinned_host_gib=0.1875,
             warmup_rss_gib=0.625, rss_built_gib=4.5, rss_peak_gib=5.75)
WINDOW = dict(rss_start_gib=0.0, rss_end_lib_gib=0.0625,
              rss_end_anon_gib=0.0, pinned_host_gib=0.0,
              warmup_rss_gib=0.0)
WANT = dict(pre_engine_rss_gib=4.125, lib_rss_gib=3.25, anon_rss_gib=1.5,
            pinned_host_gib=0.1875, warmup_rss_gib=0.625)
# the counter each reader needs in the run's total
NEEDS = dict(pre_engine_rss_gib="rss_start_gib",
             lib_rss_gib="rss_end_lib_gib", anon_rss_gib="rss_end_anon_gib",
             pinned_host_gib="pinned_host_gib",
             warmup_rss_gib="warmup_rss_gib")


def _ctx(total=TOTAL):
    return dict(window_s=40.0, prof=dict(WINDOW), prof_total=dict(total))


@pytest.mark.parametrize("name", sorted(WANT))
def test_memory_reader_on_a_run(name):
    assert registry.metric_reader(name)(_ctx()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(NEEDS))
def test_memory_reader_without_its_counter_reads_nothing(name):
    total = dict(TOTAL)
    total.pop(NEEDS[name])
    assert registry.metric_reader(name)(_ctx(total)) is None
    # a program with the counter at 0 reads a number
    total[NEEDS[name]] = 0.0
    assert registry.metric_reader(name)(_ctx(total)) == 0.0


def test_memory_readers_are_in_the_manifest():
    """Each reads a program counter, moves the host peak and lists the two
    cells whose runs have the counters."""
    man = {m["name"]: m for m in registry.manifest()["per_layer"]}
    for name in WANT:
        m = man[name]
        assert m["source"] == "program_counter" and m["unit"] == "GiB"
        assert m["moves"] == "host_rss_peak_gib"
        assert m["workloads"] == ["chrom2k.regions", "genome40k.regions"]
