"""The port's counting stage against the benchmark's plain reference of
CQF-deNoise's mid-stream sweeps (``benchmarks/reference/denoise.py``), on
the CPU at a small size: 1,200 reads of 100 bp at 2 % substitutions from a
3 kbp genome, k = 21, batches of 32 rows of 104 bases, a 2^14-slot
buffer, so that folds fire early on the near-trigger rule and sweeps drop
keys in mid-stream.

The reference models the merge cadence from the stated geometry alone;
the port's ``build_spectrum`` has to give its keys, counts, rounds, keys
swept and early merges exactly.  The reference with its near-trigger rule
off, or with its hash in 32-bit words, is the control and has to read
apart.  The spans ``count:merge.deNoise`` (with the last chunk's
``count:finalize merge+sweeps.deNoise``) and ``count:merge.early`` open
once a round and once an early merge.  Tolerance: exact."""

import functools
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference import denoise, spectrum as ref_spectrum  # noqa: E402
from sh_assembly_tpu_torch import config as cfg  # noqa: E402
from sh_assembly_tpu_torch.io import fastq  # noqa: E402
from sh_assembly_tpu_torch.models import counter  # noqa: E402
from sh_assembly_tpu_torch.ops import spectrum as sp  # noqa: E402
from sh_assembly_tpu_torch.utils import profiling  # noqa: E402

K, QB = 21, 14
KEY_BITS = QB + 8
ROWS, ROW_LEN, SLOTS = 32, 104, 1 << 14
GEOMETRY = {"batch_rows": ROWS, "row_len": ROW_LEN, "buffer_slots": SLOTS}
SWEEP_SPANS = ("count:merge.deNoise", "count:finalize merge+sweeps.deNoise")
EARLY_SPAN = "count:merge.early"
# (rounds stated, trigger, rounds that fire, of them on the last chunk)
CASES = {"one_round": (1, 12000, 1, 0), "three_rounds": (3, 8000, 3, 0),
         "last_chunk": (1, 34500, 1, 1), "no_round": (0, 1 << 40, 0, 0)}


@functools.lru_cache(maxsize=None)
def _reads() -> np.ndarray:
    """u8 base codes [1200, 100], both strands, 2 % substitutions."""
    rng = np.random.default_rng(2718281828)
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    starts = rng.integers(0, 3000 - 100 + 1, 1200)
    reads = genome[starts[:, None] + np.arange(100)]
    rev = rng.random(1200) < 0.5
    reads[rev] = 3 - reads[rev, ::-1]
    sub = rng.random(reads.shape) < 0.02
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()),
                                            dtype=np.uint8)) % 4
    return reads


def _ref_sizing(rounds: int, trigger: int) -> dict:
    return {"k": K, "key_bits": KEY_BITS, "rounds": rounds,
            "trigger": trigger, "end_denoise": True}


@functools.lru_cache(maxsize=None)
def _port(rounds: int, trigger: int):
    """(keys, counts, stats, {span: (calls, parent)}) of the port's
    build_spectrum."""
    batcher = fastq.Batcher(K, ROWS, ROW_LEN)
    batches = [b for r in _reads() for b in batcher.add_read(r)]
    batches += list(batcher.flush())
    sizing = cfg.CounterSizing(
        k=K, qb=QB, hb=KEY_BITS, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=rounds, ndistinct_for_deNoise=trigger,
        end_deNoise=True, fr=0.0)
    profiling.reset()
    spec, stats = counter.build_spectrum(
        iter(batches), sizing, capacity=1 << 17, buf_capacity=SLOTS,
        batch_cfg=cfg.BatchConfig(ROWS, ROW_LEN), device="cpu")
    spans = {n: (s.calls, s.parent)
             for n, s in profiling.GLOBAL.stats.items()}
    keys, counts = sp.to_host(spec, KEY_BITS)[:2]
    return keys, counts, stats, spans


def _reference(rounds: int, trigger: int, **kw) -> denoise.Result:
    return denoise.spectrum(torch.from_numpy(_reads()),
                            _ref_sizing(rounds, trigger), GEOMETRY, **kw)


def _apart(prog, ref: denoise.Result) -> dict:
    return ref_spectrum.compare(prog[0], prog[1], ref.keys, ref.counts)


@pytest.mark.parametrize("case", ["one_round", "three_rounds", "last_chunk"])
def test_port_equals_the_reference(case):
    rounds, trigger, fired, _ = CASES[case]
    keys, counts, stats, _ = _port(rounds, trigger)
    ref = _reference(rounds, trigger)
    assert _apart((keys, counts), ref) == {"keys_apart": 0,
                                           "counts_apart": 0}
    assert stats.rounds == ref.rounds == fired
    assert stats.swept == ref.swept > 0
    assert stats.early_merges == ref.early_merges > 0
    assert stats.merges == ref.merges
    assert stats.sweeps == fired + 1  # and the end sweep
    assert len(keys) == ref.keys.numel() > 1000


def test_no_round_equals_the_plain_spectrum():
    keys, counts, stats, _ = _port(*CASES["no_round"][:2])
    ref = _reference(*CASES["no_round"][:2])
    pk, pc, total, _ = ref_spectrum.spectrum(
        torch.from_numpy(_reads()), _ref_sizing(*CASES["no_round"][:2]))
    assert torch.equal(ref.keys, pk) and torch.equal(ref.counts, pc)
    assert _apart((keys, counts), ref) == {"keys_apart": 0,
                                           "counts_apart": 0}
    assert ref.rounds == ref.swept == ref.early_merges == 0
    assert int(counts.sum()) == stats.kmers < total


@pytest.mark.parametrize("case", ["one_round", "three_rounds"])
def test_cadence_control_reads_apart(case):
    rounds, trigger = CASES[case][:2]
    keys, counts, stats, _ = _port(rounds, trigger)
    ref = _reference(rounds, trigger, near_trigger=False)
    assert ref.early_merges == 0 and ref.rounds == stats.rounds
    apart = _apart((keys, counts), ref)
    assert apart["keys_apart"] > 0 and apart["counts_apart"] > 0
    assert ref.swept != stats.swept


def test_hash_control_reads_apart():
    keys, counts, _, _ = _port(*CASES["three_rounds"][:2])
    ref = _reference(*CASES["three_rounds"][:2], bits=32)
    assert _apart((keys, counts), ref)["keys_apart"] > 1000


@pytest.mark.parametrize("case", ["one_round", "three_rounds", "last_chunk"])
def test_spans_open_once_a_round_and_an_early_merge(case):
    rounds, trigger, fired, last = CASES[case]
    _, _, stats, spans = _port(rounds, trigger)
    calls = {n: c for n, (c, _) in spans.items()}
    assert sum(calls.get(n, 0) for n in SWEEP_SPANS) == stats.rounds
    assert calls.get(SWEEP_SPANS[1], 0) == last
    assert calls[EARLY_SPAN] == stats.early_merges
    assert calls["count:merge"] > stats.early_merges  # full buffers too
    for name in (*SWEEP_SPANS, EARLY_SPAN):
        if name in spans:  # a child of the span its name extends
            assert spans[name][1] == name.rsplit(".", 1)[0]


def test_a_run_with_no_rounds_reads_zero():
    _, _, stats, spans = _port(*CASES["no_round"][:2])
    assert (stats.rounds, stats.swept, stats.early_merges) == (0, 0, 0)
    assert stats.sweeps == 1 and stats.merges > 1
    assert not any(n in spans for n in (*SWEEP_SPANS, EARLY_SPAN))


def test_the_reference_refuses_what_it_does_not_model():
    reads = torch.from_numpy(_reads())
    with pytest.raises(ValueError, match="tile"):
        denoise.spectrum(reads, _ref_sizing(1, 10),
                         {**GEOMETRY, "row_len": 96})
    with pytest.raises(ValueError, match="two batches"):
        denoise.spectrum(reads, _ref_sizing(1, 10),
                         {**GEOMETRY, "buffer_slots": 4096})
