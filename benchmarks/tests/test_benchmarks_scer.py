"""The yeast cell's parts: ``scer-r64``'s stated sizing against the port's
own ``config.size_counter`` at the flags and read count the cell hands
the program (no reads are made); the cell found by name on the existing
``pipeline`` entry and ``pipeline.30x`` traffic; and the simplification's
six span readers, on phase stats and on nothing; the 30x cell's layers
read on this cell too."""

from __future__ import annotations

import pytest

from shbench import cellflags, generate, registry

CELL = "scer.pipeline.30x"
SPANS = {"simplify_build_s": "simplify.build",
         "simplify_tips_s": "simplify.tips",
         "simplify_bubbles_s": "simplify.bubbles",
         "simplify_ec_s": "simplify.ec",
         "simplify_compact_s": "simplify.compact",
         "contigs_write_s": "simplify.write"}
# the 100x cell reports its two sweep metrics alone
PIPELINE_CELLS = ["scer.pipeline.30x", "ecoli.pipeline.30x"]
# the 30x cell's per-layer metrics that this cell reports too
SHARED = ["count_s.pipeline", "collect_s", "probes_s", "contract_s",
          "host_assembly_s", "simplify_s", "device_idle_pct.pipeline"]


def test_the_stated_sizing_is_what_the_flags_give():
    from sh_assembly_tpu_torch import config as cfg
    from sh_assembly_tpu_torch.cli import pipeline

    c = registry.resolve(CELL)
    config, traffic = c["config"], c["traffic"]
    n = generate.n_reads(config, traffic)
    assert n == 2_431_421
    flags = cellflags.cli_flags(config, traffic, n)
    assert flags[-4:] == ["-n", "12157105", "-N", "252867784"]
    args = pipeline.make_parser().parse_args([*flags, "-i", "reads.txt"])
    sizing = cfg.size_counter(
        k=args.k, n_true_kmers=args.trueKmer, total_kmers=args.total_kmers,
        alpha=args.alpha, num_deNoise=args.deNoise,
        end_deNoise=args.endDeNoise)
    assert (sizing.qb, sizing.hb, sizing.num_deNoise,
            sizing.ndistinct_for_deNoise) == (26, 34, 0, 38_521_959)
    cellflags.refuse_other_sizing(config, sizing)
    # a 2^26-slot store: twice the 30x cell's, K5's keys a bit wider
    e = registry.resolve("ecoli.pipeline.30x")["config"]["sizing"]
    assert (sizing.qb, sizing.hb) == (e["qb"] + 1, e["key_bits"] + 1)


def test_the_cell_runs_the_existing_entry_and_traffic():
    bench = registry.load_benchmark()
    c = registry.resolve(CELL)
    ecoli = registry.resolve("ecoli.pipeline.30x")
    assert c["cell"]["traffic"] == ecoli["cell"]["traffic"] == "pipeline.30x"
    assert c["cell"]["chips"] == 1
    assert c["entry"].__doc__ == ecoli["entry"].__doc__
    assert set(c["entry"].LIMITS) == {
        "spectrum_keys_apart", "spectrum_counts_apart", "unitigs_apart",
        "links_apart", "contigs_apart"}
    assert not any(c["entry"].LIMITS.values())
    assert c["config"]["reduced"] == ["genome_sequence"]
    conf = next(x for x in bench["configs"] if x["name"] == "scer-r64")
    assert conf["reduced"] == c["config"]["reduced"]
    others = [x["source"] for x in bench["configs"] if x is not conf]
    assert conf["source"] not in others
    assert [m["name"] for m in c["end_to_end"]] == [
        "assembly_s", "peak_device_gib", "setup_s"]
    layer = [m["name"] for m in c["per_layer"]]
    assert set(SPANS) <= set(layer)
    assert set(SHARED) <= set(layer)


@pytest.mark.parametrize("name", SHARED)
def test_the_cell_reports_the_30x_cell_s_layers(name):
    bench = registry.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["ecoli.pipeline.30x", CELL]
    assert entry["moves"] == "assembly_s"


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_metric_is_reported_by_the_pipeline_cells(name):
    bench = registry.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert entry["workloads"] == PIPELINE_CELLS
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"]) == ("s", "lower", "program_span",
                                "simplification", "assembly_s")
    for w in bench["workloads"]:
        e2e, layer = registry.cell_metrics(bench, w["name"])
        reported = name in {m["name"] for m in layer}
        assert reported == (w["name"] in PIPELINE_CELLS)
        if reported:
            assert "assembly_s" in {m["name"] for m in e2e}


def _phases():
    """Two jobs: every span a distinct number of seconds, the second job
    twice the first's."""
    job = {"simplify": 8.0}
    for i, span in enumerate(sorted(SPANS.values())):
        job[span] = 0.125 * (i + 1)
    return [job, {n: 2 * v for n, v in job.items()}]


def _reader(name):
    return registry.load_module(registry.metric_path(name), f"m_{name}")


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_reads_its_span(name):
    phases = _phases()
    got = _reader(name).read({"phases": phases})
    assert got == pytest.approx(1.5 * phases[0][SPANS[name]])


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_with_its_span_absent(name):
    span = SPANS[name]
    without = [{n: v for n, v in p.items() if n != span}
               for p in _phases()]
    assert _reader(name).read({"phases": without}) is None
    assert _reader(name).read({"phases": [{"simplify": 1.0}, {}]}) is None
