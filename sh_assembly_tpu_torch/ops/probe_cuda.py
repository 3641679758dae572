"""Kernel K8: the Contiger's node probes, keys and canonical k-mers of every
successor and suffix sibling of every node.

Replaces the probe part of the JAX package's ``jax.jit`` programs
``phantom_candidates`` and ``build_oriented_graph``
(``sh_assembly_tpu/models/contiger.py``: ``_node_hashes``,
``revcomp_packed``, ``_succ_probes``, ``_sibling_probes``), which reach no
``pl.pallas_call``, with the hand-written CUDA kernel
``csrc/node_probes.cu``: one thread a node computes its ntHash pair by the
O(k) loop, its reverse complement, and every probe, and writes them
straight into the [rows, N] outputs (its header says what bounds it on the
card).  ``models/contiger`` (``phantom_candidates``,
``build_oriented_graph``) and the mesh Contiger's closure and graph
(``parallel/sharded_contiger.py``) call it.

Contract of ``node_probes(hi, lo, k, key_bits, mode)``:
  hi, lo: contiguous 1-D int64 tensors of N nodes, left-aligned k-mers
        (``kmerpack``), (-1, -1) padding rows allowed (their probes are
        whatever the chain gives them; the callers mask them);
  mode "graph" -> (keys int64[9, N], hi int64[8, N], lo int64[8, N],
        flip int32[8, N]): row 0 of keys is the node's own key, rows 1-8
        and the other outputs' rows 0-7 the successors, o = 0 then o = 1
        (the node and its reverse complement), the appended base X = 0..3;
  mode "closure" -> (keys int64[16, N], hi int64[16, N], lo int64[16, N],
        None): the 8 successors as above, then the 8 suffix siblings (base
        0 replaced, o = 0 then 1, base 0..3);
  a key is min(fh, rh) & (2^key_bits - 1) of the probe's ntHash pair, a
  word pair the canonical k-mer (the unsigned min of the probe and its
  reverse complement), a flip 1 where the reverse complement is canonical.
  This row order is the one ``torch.cat`` of the chain's lists gives, and
  the callers' ``reshape(P, N)`` and the closure's truncation rule depend
  on it.

CUDA tensors launch the kernel, and any failure raises.  CPU tensors take
``node_probes_plain``, the chain of PyTorch operations the kernel replaces
(``node_hashes``, ``succ_probes``, ``sibling_probes``); it also runs on
CUDA tensors when called by name, which is how the kernel is checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import bits, kmerpack as kp, nthash

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

MODES = ("graph", "closure")

# Output rows: (keys, words, flips) a mode
ROWS = {"graph": (9, 8, 8), "closure": (16, 16, 0)}

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("node_probes")
        lib.node_probes_launch.restype = ctypes.c_int
        lib.node_probes_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # hi, lo, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # k, key_bits, closure
            ctypes.c_void_p, ctypes.c_void_p,          # keys, hi_out
            ctypes.c_void_p, ctypes.c_void_p,          # lo_out, flips
            ctypes.c_void_p,                           # stream
        ]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def _check(hi, lo, k, key_bits, mode) -> int:
    """Check the arguments -> N."""
    for name, t in (("hi", hi), ("lo", lo)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int64 tensor")
    if lo.numel() != hi.numel() or lo.device != hi.device:
        raise ValueError("lo differs from hi in length or device")
    if not 1 <= k <= 63:
        raise ValueError(f"k {k} outside [1, 63]")
    if not 1 <= key_bits <= 63:
        raise ValueError(f"key_bits {key_bits} outside [1, 63]")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    return hi.numel()


def node_probes_cuda(hi, lo, k: int, key_bits: int, mode: str):
    """Launch K8 on hi's GPU and current stream (module docstring)."""
    global LAUNCHES
    N = _check(hi, lo, k, key_bits, mode)
    if not hi.is_cuda:
        raise ValueError("node_probes_cuda needs its tensors on a GPU")
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("hi and lo must be contiguous")
    nk, nw, nf = ROWS[mode]
    dev = hi.device
    keys = torch.empty((nk, N), dtype=torch.int64, device=dev)
    whi = torch.empty((nw, N), dtype=torch.int64, device=dev)
    wlo = torch.empty((nw, N), dtype=torch.int64, device=dev)
    flip = torch.empty((nf, N), dtype=torch.int32, device=dev) if nf \
        else None
    if N == 0:
        return keys, whi, wlo, flip
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.node_probes_launch(
            hi.data_ptr(), lo.data_ptr(), N, k, key_bits,
            int(mode == "closure"), keys.data_ptr(), whi.data_ptr(),
            wlo.data_ptr(), flip.data_ptr() if nf else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"node_probes kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return keys, whi, wlo, flip


def node_probes(hi, lo, k: int, key_bits: int, mode: str):
    """K8 for CUDA tensors, its plain chain for CPU tensors."""
    fn = node_probes_cuda if hi.is_cuda else node_probes_plain
    return fn(hi, lo, k, key_bits, mode)


def node_probes_plain(hi, lo, k: int, key_bits: int, mode: str):
    """Pure-torch twin of K8 on any device: the chain of the JAX package's
    probe programs."""
    _check(hi, lo, k, key_bits, mode)
    mask = (1 << key_bits) - 1
    fh0, rh0 = node_hashes(hi, lo, k)
    rhi, rlo = kp.revcomp_packed(hi, lo, k)
    keys, shi, slo, sflip = succ_probes(hi, lo, rhi, rlo, fh0, rh0, k, mask)
    if mode == "graph":
        return (torch.stack([bits.umin(fh0, rh0) & mask] + keys),
                torch.stack(shi), torch.stack(slo), torch.stack(sflip))
    skeys, whi, wlo = sibling_probes(hi, lo, rhi, rlo, fh0, rh0, k, mask)
    return (torch.stack(keys + skeys), torch.stack(shi + whi),
            torch.stack(slo + wlo), None)


def _rol(x: torch.Tensor, s: int) -> torch.Tensor:
    s = s % 64
    if s == 0:
        return x
    return (x << s) | bits.srl(x, 64 - s)


def node_hashes(hi, lo, k: int):
    """(fh, rh) of each node's k-mer (O(k) vector ops)."""
    seeds = nthash.seed_table(hi.device)
    cseeds = nthash.cseed_table(hi.device)
    fh = torch.zeros_like(hi)
    rh = torch.zeros_like(hi)
    for j in range(k):
        b = kp.base_at(hi, lo, j, k).long()
        fh = fh ^ _rol(seeds[b], (k - 1 - j) % 64)
        rh = rh ^ _rol(cseeds[b], j % 64)
    return fh, rh


def succ_probes(hi, lo, rhi, rlo, fh0, rh0, k: int, mask: int):
    """The 8 successor probes of both orientations of every node: the
    batched form of the reference's get_unitig_forward point queries.

    Returns (probe_keys[8], succ_hi[8], succ_lo[8] canonical packed
    successor k-mers, succ_flip[8] int32 orientation flips).
    """
    seeds = nthash.seed_table(hi.device)
    cseeds = nthash.cseed_table(hi.device)
    probe_keys, succ_hi, succ_lo, succ_flip = [], [], [], []
    for o in range(2):
        ohi = hi if o == 0 else rhi
        olo = lo if o == 0 else rlo
        ofh = fh0 if o == 0 else rh0
        orh = rh0 if o == 0 else fh0
        out_b = kp.first_base(ohi, olo, k).long()
        for X in range(4):
            sfh = _rol(ofh, 1) ^ _rol(seeds[out_b], k % 64) ^ seeds[X]
            srh = _rol(orh, 63) ^ _rol(cseeds[out_b], 63) ^ \
                _rol(cseeds[X], (k - 1) % 64)
            probe_keys.append(bits.umin(sfh, srh) & mask)
            shi, slo = kp.shift_in_base(ohi, olo, X, k)
            srchi, srclo = kp.revcomp_packed(shi, slo, k)
            schi, sclo, sflip = kp.canonicalize(shi, slo, srchi, srclo)
            succ_hi.append(schi)
            succ_lo.append(sclo)
            succ_flip.append(sflip.int())
    return probe_keys, succ_hi, succ_lo, succ_flip


def sibling_probes(hi, lo, rhi, rlo, fh0, rh0, k: int, mask: int):
    """The 8 suffix-sibling candidate probes of both orientations.

    Siblings share a junction's (k-1)-suffix (the reference's before-side
    spawns); the hash replaces the base-0 term of the ntHash XOR.

    Returns (probe_keys[8], sib_hi[8], sib_lo[8] canonical packed k-mers).
    """
    seeds = nthash.seed_table(hi.device)
    cseeds = nthash.cseed_table(hi.device)
    probe_keys, sib_hi, sib_lo = [], [], []
    for o in range(2):
        ohi = hi if o == 0 else rhi
        olo = lo if o == 0 else rlo
        ofh = fh0 if o == 0 else rh0
        orh = rh0 if o == 0 else fh0
        t0 = kp.first_base(ohi, olo, k).long()
        for Y in range(4):
            sfh = ofh ^ _rol(seeds[t0], (k - 1) % 64) ^ \
                _rol(seeds[Y], (k - 1) % 64)
            srh = orh ^ cseeds[t0] ^ cseeds[Y]
            probe_keys.append(bits.umin(sfh, srh) & mask)
            whi, wlo = kp.replace_first_base(ohi, olo, Y, k)
            wrchi, wrclo = kp.revcomp_packed(whi, wlo, k)
            wchi, wclo, _wf = kp.canonicalize(whi, wlo, wrchi, wrclo)
            sib_hi.append(wchi)
            sib_lo.append(wclo)
    return probe_keys, sib_hi, sib_lo
