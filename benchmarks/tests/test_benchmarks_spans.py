"""The readers of the spans inside the host phases (the reader's wait, the
contraction's four steps, the host assembly's six): each reads its own span
from the program's phase times, a mean over the jobs, and nothing where
the span never ran."""

from __future__ import annotations

import pytest

from shbench import registry

# metric -> (span, cell)
SPANS = {
    "ingest_wait_s.count": ("count:host read/pack.wait", "celegans.count"),
    "reader_s.count": ("count:reader next", "celegans.count"),
    "ingest_wait_s.pipeline": ("count:host read/pack.wait",
                               "ecoli.pipeline.30x"),
    "collect_wait_s": ("contiger:collect nodes.wait", "ecoli.pipeline.30x"),
    "contract_d2h_s": ("contiger:contract.d2h", "ecoli.pipeline.30x"),
    "contract_walk_s": ("contiger:contract.walk", "ecoli.pipeline.30x"),
    "contract_revcomp_s": ("contiger:contract.revcomp",
                           "ecoli.pipeline.30x"),
    "contract_keep_s": ("contiger:contract.keep rule", "ecoli.pipeline.30x"),
    "host_members_s": ("contiger:host assembly.members",
                       "ecoli.pipeline.30x"),
    "host_dedup_s": ("contiger:host assembly.dedup", "ecoli.pipeline.30x"),
    "host_medians_s": ("contiger:host assembly.medians",
                       "ecoli.pipeline.30x"),
    "host_links_s": ("contiger:host assembly.links", "ecoli.pipeline.30x"),
    "host_components_s": ("contiger:host assembly.components",
                          "ecoli.pipeline.30x"),
    "host_sequences_s": ("contiger:host assembly.sequences",
                         "ecoli.pipeline.30x"),
}
PARENTS = {"count:host read/pack": 4.0, "contiger:collect nodes": 3.0,
           "contiger:contract": 9.0, "contiger:host assembly": 12.0}


def _phases():
    """Two jobs: every span a distinct number of seconds, the second job
    twice the first's."""
    job = dict(PARENTS)
    for i, (span, _) in enumerate(sorted(set(SPANS.values()))):
        job[span] = 0.125 * (i + 1)
    return [job, {n: 2 * v for n, v in job.items()}]


def _reader(name):
    return registry.load_module(registry.metric_path(name), f"m_{name}")


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_reads_its_span(name):
    phases = _phases()
    span = SPANS[name][0]
    got = _reader(name).read({"phases": phases})
    assert got == pytest.approx(1.5 * phases[0][span])


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_with_its_span_absent(name):
    span = SPANS[name][0]
    without = [{n: v for n, v in p.items() if n != span}
               for p in _phases()]
    assert _reader(name).read({"phases": without}) is None
    assert _reader(name).read({"phases": [{}, {}]}) is None


def test_a_job_without_the_span_counts_as_zero():
    span = SPANS["contract_walk_s"][0]
    phases = [{span: 3.0}, {"contiger:contract": 1.0}]
    assert _reader("contract_walk_s").read({"phases": phases}) == 1.5


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_metric_is_reported_by_its_cell_only(name):
    bench = registry.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    cell = SPANS[name][1]
    assert entry["workloads"] == [cell]
    assert (entry["unit"], entry["better"], entry["source"]) == (
        "s", "lower", "program_span")
    for w in bench["workloads"]:
        _, layer = registry.cell_metrics(bench, w["name"])
        assert (name in {m["name"] for m in layer}) == (w["name"] == cell)
