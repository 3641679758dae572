"""The port's phase timer (``utils/profiling.py``): nested spans and their
parents, spans that leave CUDA alone, a stack of open spans a thread, the
report's trees and coverage; then the spans inside the host phases of a
pipeline run and a count run on the CPU, and the simplification's spans
in a pipeline run whose ``contigs.fa`` is the JAX package's, byte for
byte."""

import re
import sys
import threading
import time

import pytest

from sh_assembly_tpu.cli import pipeline as jpipeline_cli
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.cli import pipeline as pipeline_cli
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import counter
from sh_assembly_tpu_torch.utils import profiling
from test_torch_pipeline import READS, _pipeline_argv, workload  # noqa: F401

# span -> its parent, as the program opens them
COUNT_SPANS = {
    "count:host read/pack.wait": "count:host read/pack",
    "count:reader next": None,  # on the prefetch thread
}
CONTIGER_SPANS = {
    "contiger:collect nodes.wait": "contiger:collect nodes",
    **{f"contiger:contract.{s}": "contiger:contract"
       for s in ("d2h", "walk", "revcomp", "keep rule")},
    **{f"contiger:host assembly.{s}": "contiger:host assembly"
       for s in ("members", "dedup", "medians", "links", "components",
                 "sequences")},
}
SIMPLIFY_SPANS = {f"simplify.{s}": "simplify"
                  for s in ("build", "tips", "bubbles", "ec", "compact",
                            "write")}


def test_a_nested_span_records_its_parent():
    t = profiling.PhaseTimer()
    with t.phase("a", sync=False):
        with t.phase("a.b", sync=False):
            with t.phase("a.b.c", sync=False):
                pass
        with t.phase("a.d", sync=False):
            pass
    with t.phase("e", sync=False):
        pass
    assert {n: s.parent for n, s in t.stats.items()} == {
        "a": None, "a.b": "a", "a.b.c": "a.b", "a.d": "a", "e": None}
    assert all(s.calls == 1 for s in t.stats.values())


def test_a_span_that_raises_leaves_the_stack_closed():
    t = profiling.PhaseTimer()
    with pytest.raises(ValueError):
        with t.phase("a", sync=False):
            raise ValueError
    with t.phase("b", sync=False):
        pass
    assert t.stats["b"].parent is None and t.stats["a"].calls == 0


def test_sync_false_never_synchronises(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "_sync", lambda: calls.append(1))
    t = profiling.PhaseTimer()
    with t.phase("host", sync=False):
        with t.phase("host.step", sync=False):
            pass
    assert calls == []
    with t.phase("device"):
        with t.phase("device.step", sync=False):
            pass
    assert calls == [1]  # the patch is the one the timer calls


def test_a_second_thread_has_its_own_stack():
    t = profiling.PhaseTimer()
    opened, release = threading.Event(), threading.Event()

    def worker():
        with t.phase("w", sync=False):
            opened.set()
            release.wait(5)
            with t.phase("w.step", sync=False):
                pass

    with t.phase("main", sync=False):
        th = threading.Thread(target=worker, name="second")
        th.start()
        assert opened.wait(5)
        # the worker's open span is not this thread's parent
        with t.phase("main.step", sync=False):
            pass
        release.set()
        th.join(5)
    got = {n: (s.parent, s.thread) for n, s in t.stats.items()}
    me = threading.current_thread().name
    assert got == {"main": (None, me), "main.step": ("main", me),
                   "w": (None, "second"), "w.step": ("w", "second")}


def test_many_threads_lose_no_span():
    """More threads than cores, each writing its own names, under a short
    switch interval: every call is counted, every parent kept."""
    t = profiling.PhaseTimer()
    n_threads, n_spans = 32, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for _ in range(n_spans):
                with t.phase(f"w{i}", sync=False):
                    with t.phase(f"w{i}.step", sync=False):
                        pass

        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert len(t.stats) == 2 * n_threads
    for i in range(n_threads):
        assert t.stats[f"w{i}"].calls == n_spans
        assert t.stats[f"w{i}.step"].calls == n_spans
        assert t.stats[f"w{i}"].parent is None
        assert t.stats[f"w{i}.step"].parent == f"w{i}"


def _row(report, name):
    return next(line for line in report.splitlines()
                if line.strip().startswith(name + " "))


def test_report_nests_children_with_self_time_and_covers_at_most_all():
    t = profiling.PhaseTimer()
    with t.phase("p", sync=False):
        with t.phase("p.a", sync=False):
            time.sleep(0.03)
        with t.phase("p.b", sync=False):
            time.sleep(0.01)
        time.sleep(0.01)
    def beside():
        with t.phase("beside", sync=False):
            time.sleep(0.02)

    th = threading.Thread(target=beside, name="beside")
    with t.phase("q", sync=False):
        th.start()
        th.join(5)
    rep = t.report("test")
    covered = int(re.search(r"(\d+)% covered", rep).group(1))
    assert 90 <= covered <= 100
    lines = rep.splitlines()
    indent = {n: len(_row(rep, n)) - len(_row(rep, n).lstrip())
              for n in ("p", "p.a", "p.b", "q")}
    assert indent["p.a"] == indent["p.b"] == indent["p"] + 2
    assert indent["q"] == indent["p"]
    # children follow their parent, longest first
    order = [i for i, line in enumerate(lines)
             for n in ("p", "p.a", "p.b") if line.strip().startswith(n + " ")]
    assert order == sorted(order)
    st = t.stats
    own = float(re.search(r"self (-?[\d.]+)s", _row(rep, "p")).group(1))
    assert own == pytest.approx(st["p"].seconds - st["p.a"].seconds
                                - st["p.b"].seconds, abs=0.006)
    assert "self" not in _row(rep, "p.a")
    # another thread's spans are listed apart, outside the coverage
    at = lines.index("  on other threads, beside the above:")
    assert lines[at + 1].strip().startswith("beside ")


def _expect(spans):
    stats = profiling.GLOBAL.stats
    missing = sorted(set(spans) - set(stats))
    assert not missing, missing
    for name, parent in spans.items():
        assert stats[name].parent == parent, name
        assert stats[name].calls >= 1, name


def test_pipeline_run_records_every_host_span(workload, tmp_path):
    assert pipeline_cli.main(_pipeline_argv(workload, 47, tmp_path, "port")
                             + ["--device", "cpu"]) == 0
    _expect({**COUNT_SPANS, **CONTIGER_SPANS, **SIMPLIFY_SPANS})
    stats = profiling.GLOBAL.stats
    assert stats["count:reader next"].thread == "prefetch"
    for parent, n in (("contiger:contract", 4),
                      ("contiger:host assembly", 6), ("simplify", 6)):
        kids = [s.seconds for name, s in stats.items()
                if name.startswith(parent + ".")]
        assert len(kids) == n
        assert sum(kids) <= stats[parent].seconds
    # one wait a batch pulled, and one more for the stream's end
    assert (stats["count:host read/pack.wait"].calls
            == stats["count:host read/pack"].calls)


@pytest.mark.parametrize("k", [21, 47])
def test_simplify_spans_never_sync_and_leave_contigs_as_jax_writes_them(
        workload, tmp_path, monkeypatch, k):
    """The six spans inside ``simplify`` are its children, one build and
    one write a job, a pass each and three recompactions a round; none
    of them synchronises (each is host work); and the contigs are the
    JAX pipeline's, byte for byte."""
    assert jpipeline_cli.main(_pipeline_argv(workload, k, tmp_path,
                                             "jax")) == 0
    synced = []
    monkeypatch.setattr(profiling, "_sync", lambda: synced.append(
        profiling.GLOBAL._stack()[-1]))
    assert pipeline_cli.main(_pipeline_argv(workload, k, tmp_path, "port")
                             + ["--device", "cpu"]) == 0
    _expect(SIMPLIFY_SPANS)
    st = profiling.GLOBAL.stats
    assert "simplify" in synced  # the patch is the one the timer calls
    assert not [n for n in synced if n in SIMPLIFY_SPANS]
    rounds = st["simplify.tips"].calls
    assert rounds >= 1
    assert st["simplify.bubbles"].calls == st["simplify.ec"].calls == rounds
    assert st["simplify.compact"].calls == 3 * rounds
    assert st["simplify.build"].calls == st["simplify.write"].calls == 1
    assert all(st[n].thread == st["simplify"].thread for n in SIMPLIFY_SPANS)
    assert (sum(st[n].seconds for n in SIMPLIFY_SPANS)
            <= st["simplify"].seconds)
    ref = (tmp_path / "contigs_jax.fa").read_bytes()
    assert ref.count(b">") > 0
    assert (tmp_path / "contigs_port.fa").read_bytes() == ref


def test_count_run_records_the_reader_and_its_wait(workload):
    k = 47
    sizing = cfg.size_counter(
        k=k, n_true_kmers=READS["genome_len"],
        total_kmers=READS["n_reads"] * (READS["read_len"] - k + 1),
        alpha=READS["sub_rate"], num_deNoise=0)
    profiling.reset()
    _, stats = counter.build_spectrum_from_files(
        fastq.read_file_list(str(workload / "ReadFiles.txt")), sizing,
        device="cpu")
    assert stats.batches >= 1
    _expect(COUNT_SPANS)
    st = profiling.GLOBAL.stats
    # the reader hands over every batch and then the stream's end
    assert st["count:reader next"].calls == stats.batches + 1
    assert st["count:host read/pack.wait"].calls == stats.batches + 1
    assert (st["count:host read/pack.wait"].seconds
            <= st["count:host read/pack"].seconds)
