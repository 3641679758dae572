"""cqf_dump — inspect a .ser counting-filter file.

Debug equivalent of the reference's qf_dump/qf_print_metadata/qfi iteration
(gqf.c:949-962, 2474-2601).  Prints metadata then "key count traveled"
lines (sorted by key), matching the tests/ref_harness dump format.
"""

from __future__ import annotations

import argparse
import sys

from ..formats import cqf_ser


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="cqf_dump")
    p.add_argument("ser", help=".ser file")
    p.add_argument("--meta-only", action="store_true")
    p.add_argument("--limit", type=int, default=0, help="max entries to print")
    args = p.parse_args(argv)

    m, keys, counts, trav = cqf_ser.read_ser(args.ser)
    print(f"# seed={m.seed} nslots={m.nslots} xnslots={m.xnslots} "
          f"key_bits={m.key_bits} key_remainder_bits={m.key_remainder_bits} "
          f"bits_per_slot={m.bits_per_slot} nblocks={m.nblocks}",
          file=sys.stderr)
    print(f"# nelts={m.nelts} ndistinct_elts={m.ndistinct_elts} "
          f"entries={len(keys)}", file=sys.stderr)
    if args.meta_only:
        return 0
    n = len(keys) if not args.limit else min(args.limit, len(keys))
    for i in range(n):
        print(f"{keys[i]} {counts[i]} {int(trav[i])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
