"""The control that the comparison has to fail.

The system states no precision, so the control breaks one guarantee that
the configuration states: the lowest qualifying nonce. It is the
reference put in the program's place, mining the cell's chain with half
of the nonce space left out: only even 32-nonce slices are searched (the
"half of the batch left out" of a sweep that skips every other slice).
Its blocks are valid proof of work and link correctly; a block whose
lowest qualifier lies in an odd slice gets a higher nonce, which the
reference's lowest-nonce scan finds.

    python -m benchmark.control --workload fused-d24 --blocks 12 \
        --seeds 11 12 13

mines one control chain a seed on card 0 at the cell's difficulty and
prints the comparison's readings, as a run would print them.
"""
from __future__ import annotations

import argparse
import json
import struct
import sys
import time

from . import reference, spec


class HalfScanner(reference.Scanner):
    """A scan that looks only at the nonces of even 32-nonce slices."""

    def searched(self, nonces):
        return (nonces >> 5) & 1 == 0


def mine(prefix: str, bits: int, n_blocks: int, device="cpu",
         chunk: int = 1 << 20) -> tuple[bytes, list[bytes]]:
    """The control's chain (genesis..tip) and each block's hash."""
    scanner = HalfScanner(bits, device, chunk)
    heads = [reference.genesis(bits)]
    hashes = [reference.sha256d(heads[0])]
    for h in range(1, n_blocks + 1):
        head = reference.header(hashes[-1],
                                reference.sha256d(
                                    reference.payload(prefix, h)),
                                h, bits, 0)
        nonce = scanner.lowest(head[:76], 0, reference.NONCE_SPACE)
        if nonce is None:
            raise RuntimeError(f"the control found no nonce at {h}")
        heads.append(head[:76] + struct.pack("<I", nonce))
        hashes.append(reference.sha256d(heads[-1]))
    return b"".join(heads), hashes


def readings(cell: spec.Cell, seed: int, n_blocks: int, device="cpu"
             ) -> reference.Verdict:
    """The comparison of a run, held to the control's chain for ``seed``."""
    bits = int(cell.config["difficulty_bits"])
    prefix = f"seed-{seed}"
    chain, hashes = mine(prefix, bits, n_blocks, device)
    return reference.check_chain(
        chain, prefix=prefix, bits=bits, seed=seed, block_hashes=hashes,
        scan_budget=1 << int(cell.traffic["check_nonces_pow2"]),
        scan_blocks=int(cell.traffic["check_blocks"]), device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--blocks", type=int, default=12)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    failed = 0
    for seed in args.seeds:
        t = time.perf_counter()
        v = readings(cell, seed, args.blocks, args.device)
        failed += not v.correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": v.correct, "blocks": v.blocks,
                          "scanned": [v.sampled_blocks, v.sampled_nonces],
                          "seconds": round(time.perf_counter() - t, 3),
                          "compared": v.compared()}), flush=True)
    # Every control run has to come out not correct.
    return 0 if failed == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
