"""Kernel K5: hash a stack of read batches and append the keys to the
counting buffer.

Replaces the device step of the JAX package's fused counting scan,
``sh_assembly_tpu/models/counter.py:append_scan_packed`` (and
``append_scan``, ``count_batch``), an XLA-fused ``lax.scan`` that reaches
no ``pl.pallas_call``, with the hand-written CUDA kernel
``csrc/hash_append.cu``: a block stages a tile of bases once, scans their
prefix XORs in shared memory and computes each key from four prefix
values (its header says what bounds it on the card and what the design
does about it).  The mesh counter's hash (``parallel/sharded.py``) calls
it with ``codes`` into a scratch buffer.

Contract of ``hash_append(buf, n_buf, nelts, lengths, k, key_bits, *,
packed=None, nmask=None, codes=None)``:
  lengths: int32[*lead] valid leading bases of each row; ``lead`` is
        ``(S, B)`` for a stack of S batches or ``(B,)`` for one.
  packed, nmask: u8[*lead, L/4] and u8[*lead, L/8], the 2-bit transport of
        ``ops/packio`` (L % 8 == 0); or codes: u8[*lead, L] base codes
        (0..3, 4 = N, 5 = pad), and no packed or nmask.
  buf:  the int64 log buffer; ``buf[n_buf : n_buf + R * W]`` (R rows, W =
        L - k + 1 windows a row) is written IN PLACE, row-major then
        window, as R / B consecutive one-batch appends would write it:
        ``min(fh, rh) & (2^key_bits - 1)`` for a window with i + k <=
        length, -1 for the others.
  nelts: the 0-dim int64 occurrence count.
  Returns a new 0-dim tensor: nelts plus the valid windows (``nelts`` itself
  is not written, so a Spectrum from before the append keeps its count).

CUDA tensors launch the kernel, and any failure raises.  CPU tensors take
``hash_append_plain``, the port's per-batch path (``packio.unpack``,
``nthash.windowed_canonical``, ``mask_keys``, ``torch.where``, a slice
write) looped over the batches; it also runs on CUDA tensors when called
by name, which is how the kernel is checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import bits, nthash, packio

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

# Longest row the kernel takes (a row longer than a block's tile of 4096
# bases is cut into segments that overlap by k - 1 bases).
MAX_ROW = 32768

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("hash_append")
        lib.hash_append_launch.restype = ctypes.c_int
        lib.hash_append_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,    # packed, nmask
            ctypes.c_void_p, ctypes.c_void_p,    # codes, lengths
            ctypes.c_longlong,                   # rows
            ctypes.c_int, ctypes.c_int,          # L, k
            ctypes.c_int,                        # key_bits
            ctypes.c_void_p, ctypes.c_void_p,    # out, nelts
            ctypes.c_void_p,                     # stream
        ]
        lib.hash_append_plan.restype = ctypes.c_int
        lib.hash_append_plan.argtypes = [ctypes.c_longlong, ctypes.c_int,
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
    """How a launch of ``rows`` rows of L bases at k is cut into blocks
    (rows a block, or windows a segment and segments a row for rows longer
    than a tile; blocks; dynamic shared bytes) and what the built kernel
    uses (static shared bytes, registers and local bytes a thread, blocks
    an SM).  Asks the kernel on the current GPU."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = _load().hash_append_plan(rows, L, k, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"hash_append_plan failed: CUDA error {rc}")
    return dict(zip(PLAN_FIELDS, out))


def _geometry(buf, n_buf, nelts, lengths, k, key_bits, packed, nmask,
              codes):
    """Check the arguments -> (rows, L, W)."""
    if buf.dtype != torch.int64 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous 1-D int64 tensor")
    if nelts.dtype != torch.int64 or nelts.dim() != 0:
        raise ValueError("nelts must be a 0-dim int64 tensor")
    if (packed is None, nmask is None) != ((codes is not None),) * 2:
        raise ValueError("give packed and nmask, or codes")
    if lengths.dim() == 0:
        raise ValueError("lengths needs a row dimension")
    lead = tuple(lengths.shape)
    if codes is None:
        L = packed.shape[-1] * 4
        if L % 8:
            raise ValueError(f"packed rows of {L} bases: L % 8 != 0")
        want = {"packed": (packed, torch.uint8, lead + (L // 4,)),
                "nmask": (nmask, torch.uint8, lead + (L // 8,))}
    else:
        L = codes.shape[-1]
        want = {"codes": (codes, torch.uint8, lead + (L,))}
    want["lengths"] = (lengths, torch.int32, lead)
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, buf on {buf.device}")
    if nelts.device != buf.device:
        raise ValueError(f"nelts is on {nelts.device}, buf on {buf.device}")
    if not 1 <= k <= 63 or k > L + 1:
        raise ValueError(f"k {k} outside [1, min(63, L + 1)] for rows of "
                         f"{L} bases")
    if not 1 <= key_bits <= 63:
        raise ValueError(f"key_bits {key_bits} outside [1, 63]")
    if L > MAX_ROW:
        raise ValueError(f"rows of {L} bases exceed {MAX_ROW}")
    rows = lengths.numel()
    W = L - k + 1
    if not 0 <= n_buf <= n_buf + rows * W <= buf.numel():
        raise ValueError(f"buffer overflow: {n_buf} + {rows * W} > "
                         f"{buf.numel()}")
    return rows, L, W


def hash_append_cuda(buf, n_buf, nelts, lengths, k, key_bits, *, packed=None,
                     nmask=None, codes=None):
    """Launch K5 on buf's GPU and current stream (module docstring)."""
    global LAUNCHES
    rows, L, W = _geometry(buf, n_buf, nelts, lengths, k, key_bits, packed,
                           nmask, codes)
    if not buf.is_cuda:
        raise ValueError("hash_append_cuda needs its tensors on a GPU")
    ins = [packed, nmask, codes, lengths]
    if any(t is not None and not t.is_contiguous() for t in ins):
        raise ValueError("the kernel's inputs must be contiguous")
    out_nelts = nelts.clone()
    if rows * W == 0:
        return out_nelts
    lib = _load()
    ptr = [None if t is None else t.data_ptr() for t in ins]
    with torch.cuda.device(buf.device):
        rc = lib.hash_append_launch(
            *ptr, rows, L, k, key_bits, buf.data_ptr() + 8 * n_buf,
            out_nelts.data_ptr(),
            torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hash_append kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return out_nelts


def hash_append_plain(buf, n_buf, nelts, lengths, k, key_bits, *,
                      packed=None, nmask=None, codes=None):
    """Pure-torch twin of K5 on any device: one batch (the last dim of
    lengths) at a time."""
    rows, L, W = _geometry(buf, n_buf, nelts, lengths, k, key_bits, packed,
                           nmask, codes)
    if rows * W == 0:
        return nelts.clone()
    if codes is None:
        codes = packio.unpack(packed, nmask, L)
    B = lengths.shape[-1]
    codes, lengths = codes.reshape(-1, B, L), lengths.reshape(-1, B)
    for s in range(codes.shape[0]):
        keys, valid = nthash.windowed_canonical(codes[s], lengths[s], k)
        keys = torch.where(valid, nthash.mask_keys(keys, key_bits),
                           bits.SENTINEL).reshape(-1)
        buf[n_buf:n_buf + keys.numel()] = keys
        n_buf += keys.numel()
        nelts = nelts + (keys != bits.SENTINEL).sum()
    return nelts


def hash_append(buf, n_buf, nelts, lengths, k, key_bits, *, packed=None,
                nmask=None, codes=None):
    """K5 for CUDA tensors, its plain twin for CPU tensors."""
    fn = hash_append_cuda if buf.is_cuda else hash_append_plain
    return fn(buf, n_buf, nelts, lengths, k, key_bits, packed=packed,
              nmask=nmask, codes=codes)
