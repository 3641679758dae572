"""Kernel K6: stage a stack of read rows into the Contiger's pending
candidate buffer.

Replaces the JAX package's collect staging,
``sh_assembly_tpu/models/contiger.py:_stage_super``, a ``jax.jit`` program
that reaches no ``pl.pallas_call``, with the hand-written CUDA kernel
``csrc/stage_windows.cu``: a block stages a tile of bases once, scans their
prefix XORs in shared memory as K5 does (``csrc/tile_scan.cuh``, shared by
both), and cuts each window's forward and reverse-complement words out of
two 2-bit streams of the tile (its header says what bounds it on the card
and what the design does about it).  ``models/contiger._stage_super``
(``collect_nodes``, ``profile.collect``, the bench's stage-2 rates) and the
mesh Contiger's collect (``parallel/sharded_contiger.py``) call it.

Contract of ``stage_windows(hi, lo, key, seed, n, packed, nmask, lengths,
seed_cols, k, key_bits, keys="ok")``:
  packed, nmask: u8[R, L/4] and u8[R, L/8], the 2-bit transport of
        ``ops/packio`` (L % 8 == 0); lengths and seed_cols int32[R] (the
        valid leading bases of each row, and the column of its read's
        middle k-mer, -1 = none).
  hi, lo, key: contiguous 1-D int64 tensors, seed a uint8 one, all of one
        length; entries ``[n, n + R * W)`` (W = L - k + 1 windows a row) are
        written IN PLACE, row-major then window, and nothing else:
        hi, lo   the canonical k-mer (``kmerpack``'s left-aligned pair, the
                 unsigned min of the forward and reverse-complement words)
                 where the window is ok, else -1, -1;
        key      ``min(fh, rh) & (2^key_bits - 1)`` where the window is ok
                 (``keys="ok"``, the single store) or valid (``keys="valid"``,
                 the mesh rule, N-containing windows included), else -1;
        seed     1 iff the window is ok and i == seed_cols[row], else 0;
        with valid = i + k <= length and ok = valid and no N or pad base in
        the window.
  Returns R * W, the entries written (0, with nothing written and no launch,
  when k > L).

Rows longer than one block's tile of 4096 bases are cut into segments
overlapping by k - 1 bases, as K5 cuts them; rows of more than MAX_ROW
bases are refused with a ValueError.  CUDA tensors launch the kernel, and
any failure raises.  CPU tensors take ``stage_windows_plain``, the chain of
PyTorch operations the kernel replaces (``packio.unpack``,
``nthash.windowed_canonical``, an N-free cumsum, ``kmerpack``'s
``pack_windows``, ``revcomp_packed`` and ``canonicalize``, four masked
slice writes); it also runs on CUDA tensors when called by name, which is
how the kernel is checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import bits, kmerpack as kp, nthash, packio

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

# Longest row the kernel takes (a row longer than a block's tile of 4096
# bases is cut into segments that overlap by k - 1 bases).
MAX_ROW = 32768

KEY_RULES = ("ok", "valid")

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("stage_windows")
        lib.stage_windows_launch.restype = ctypes.c_int
        lib.stage_windows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,    # packed, nmask
            ctypes.c_void_p, ctypes.c_void_p,    # lengths, seed_cols
            ctypes.c_longlong,                   # rows
            ctypes.c_int, ctypes.c_int,          # L, k
            ctypes.c_int, ctypes.c_int,          # key_bits, valid_keys
            ctypes.c_void_p, ctypes.c_void_p,    # hi, lo
            ctypes.c_void_p, ctypes.c_void_p,    # key, seed
            ctypes.c_void_p,                     # stream
        ]
        lib.stage_windows_plan.restype = ctypes.c_int
        lib.stage_windows_plan.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


PLAN_FIELDS = ("rows_per_block", "segment_windows", "segments_per_row",
               "blocks", "dynamic_smem", "static_smem", "registers",
               "local_bytes", "blocks_per_sm")


def plan(rows: int, L: int, k: int) -> dict:
    """How a launch of ``rows`` rows of L bases at k is cut into blocks and
    what the built kernel uses (``hash_append_cuda.plan``'s fields).  Asks
    the kernel on the current GPU."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = _load().stage_windows_plan(rows, L, k, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"stage_windows_plan failed: CUDA error {rc}")
    return dict(zip(PLAN_FIELDS, out))


def _geometry(hi, lo, key, seed, n, packed, nmask, lengths, seed_cols, k,
              key_bits, keys):
    """Check the arguments -> (rows, L, W), W clamped at 0."""
    for name, t, dtype in (("hi", hi, torch.int64), ("lo", lo, torch.int64),
                           ("key", key, torch.int64),
                           ("seed", seed, torch.uint8)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor")
        if t.numel() != hi.numel() or t.device != hi.device:
            raise ValueError(f"{name} differs from hi in length or device")
    if lengths.dim() != 1:
        raise ValueError("lengths must be 1-D (one entry a row)")
    rows = lengths.numel()
    L = packed.shape[-1] * 4
    if L % 8:
        raise ValueError(f"packed rows of {L} bases: L % 8 != 0")
    for name, (t, dtype, shape) in {
            "packed": (packed, torch.uint8, (rows, L // 4)),
            "nmask": (nmask, torch.uint8, (rows, L // 8)),
            "lengths": (lengths, torch.int32, (rows,)),
            "seed_cols": (seed_cols, torch.int32, (rows,))}.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != hi.device:
            raise ValueError(f"{name} is on {t.device}, hi on {hi.device}")
    if not 1 <= k <= 63:
        raise ValueError(f"k {k} outside [1, 63]")
    if not 1 <= key_bits <= 63:
        raise ValueError(f"key_bits {key_bits} outside [1, 63]")
    if keys not in KEY_RULES:
        raise ValueError(f"keys {keys!r} is not one of {KEY_RULES}")
    if L > MAX_ROW:
        raise ValueError(f"rows of {L} bases exceed {MAX_ROW}")
    W = max(L - k + 1, 0)
    if not 0 <= n <= n + rows * W <= hi.numel():
        raise ValueError(f"buffer overflow: {n} + {rows * W} > {hi.numel()}")
    return rows, L, W


def stage_windows_cuda(hi, lo, key, seed, n, packed, nmask, lengths,
                       seed_cols, k, key_bits, keys="ok") -> int:
    """Launch K6 on hi's GPU and current stream (module docstring)."""
    global LAUNCHES
    rows, L, W = _geometry(hi, lo, key, seed, n, packed, nmask, lengths,
                           seed_cols, k, key_bits, keys)
    if not hi.is_cuda:
        raise ValueError("stage_windows_cuda needs its tensors on a GPU")
    ins = (packed, nmask, lengths, seed_cols)
    if any(not t.is_contiguous() for t in ins) or packed.data_ptr() % 2:
        raise ValueError("the kernel's inputs must be contiguous, packed "
                         "at an even address")
    if rows * W == 0:
        return 0
    lib = _load()
    with torch.cuda.device(hi.device):
        rc = lib.stage_windows_launch(
            *(t.data_ptr() for t in ins), rows, L, k, key_bits,
            int(keys == "valid"),
            *(t.data_ptr() + t.element_size() * n for t in (hi, lo, key,
                                                             seed)),
            torch.cuda.current_stream(hi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stage_windows kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return rows * W


def stage_windows_plain(hi, lo, key, seed, n, packed, nmask, lengths,
                        seed_cols, k, key_bits, keys="ok") -> int:
    """Pure-torch twin of K6 on any device: the chain of the JAX package's
    ``_stage_super``."""
    rows, L, W = _geometry(hi, lo, key, seed, n, packed, nmask, lengths,
                           seed_cols, k, key_bits, keys)
    if rows * W == 0:
        return 0
    codes = packio.unpack(packed, nmask, L)
    dev = codes.device
    kk, valid = nthash.windowed_canonical(codes, lengths, k)
    kk = nthash.mask_keys(kk, key_bits)

    # windows containing any non-ACGT base are not graph nodes
    cbad = torch.cumsum((codes >= 4).int(), dim=1)
    nfree = (cbad[:, k - 1:] - torch.cat(
        [torch.zeros((rows, 1), dtype=cbad.dtype, device=dev),
         cbad[:, :W - 1]], dim=1)) == 0
    ok = valid & nfree
    is_seed = ok & (torch.arange(W, device=dev)[None, :]
                    == seed_cols.long()[:, None])

    fhi, flo = kp.pack_windows(codes, k)
    rhi, rlo = kp.revcomp_packed(fhi, flo, k)
    chi, clo, _ = kp.canonicalize(fhi, flo, rhi, rlo)

    flat = ok.reshape(-1)
    s = slice(n, n + rows * W)
    hi[s] = torch.where(flat, chi.reshape(-1), bits.SENTINEL)
    lo[s] = torch.where(flat, clo.reshape(-1), bits.SENTINEL)
    keyed = valid if keys == "valid" else ok
    key[s] = torch.where(keyed.reshape(-1), kk.reshape(-1), bits.SENTINEL)
    seed[s] = is_seed.reshape(-1).to(torch.uint8)
    return rows * W


def stage_windows(hi, lo, key, seed, n, packed, nmask, lengths, seed_cols,
                  k, key_bits, keys="ok") -> int:
    """K6 for CUDA tensors, its plain twin for CPU tensors."""
    fn = stage_windows_cuda if hi.is_cuda else stage_windows_plain
    return fn(hi, lo, key, seed, n, packed, nmask, lengths, seed_cols, k,
              key_bits, keys)
