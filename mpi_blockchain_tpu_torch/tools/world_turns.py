"""Times the two forms of a two-rank gloo world on one NVIDIA GPU in turns,
and prices one round of the fused world's host path.

    python -m mpi_blockchain_tpu_torch.tools.world_turns [--rounds 2]

Each round launches ``mine --fused --blocks-per-call 100 --coordinator``
and the per-block ``mine --coordinator`` as two processes sharing the card
(``chip_smoke.gloo_world`` at ``chip_smoke.FUSED_WORLD_CHAIN``, the
d24/n1000/b24 pin), in the order fused, per-block, per-block, fused, and
prints rank 0's ``mine_chain`` wall, each rank's sweep and step launches
and the summary's ``bubble_fraction`` of each. Then, in a gloo world of
one process, it times the pieces of one fused-world round on the card
(``round_cost``): a 2^24 slice of a block at difficulty 64 (nothing
qualifies, so the slice runs whole) and its read-back, ``winner_select``,
``put_result``, a step, and the whole round, medians of ``reps``.

The last line is one JSON object with every run, the medians per form,
the round's pieces, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import socket
import statistics
import sys
import tempfile
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
FORMS = {"fused": ["--fused", "--blocks-per-call", "100"], "per_block": []}
ORDER = ("fused", "per_block", "per_block", "fused")


def world_run(form: str) -> dict:
    """One two-rank world of ``form`` at the d24/n1000 pin."""
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke

    with tempfile.TemporaryDirectory() as td:
        summary, got, launch_wall = chip_smoke.gloo_world(
            td, FORMS[form], f"world_turns {form}",
            chain=chip_smoke.FUSED_WORLD_CHAIN, pin=(24, 1000, 24))
    return {"form": form, "wall_s": summary["wall_s"],
            "launch_wall_s": launch_wall,
            "bubble_fraction": summary["pipeline"]["bubble_fraction"],
            "launches": [chip_smoke.rank_counts(err) for _, err in got]}


def round_cost(device: str = "cuda", count: int = 1 << 24,
               reps: int = 200) -> dict:
    """Median microseconds of each piece of one fused-world round on
    ``device``, in a gloo world of this process alone: the slice of
    ``count`` nonces and its read-back, the winner-select, the copy of the
    winner, the step, and all of them in a row."""
    import torch
    import torch.distributed as dist

    from ..ops import sha256_block
    from ..parallel.mesh import winner_select

    dev = torch.device(device)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        scratch = sha256_block.new_scratch(dev)
        data = torch.ones(8, dtype=torch.uint32, device=dev)
        nonce = torch.empty(1, dtype=torch.uint32, device=dev)
        sha256_block.step(scratch, prev=torch.zeros_like(data), data=data,
                          height=1, difficulty_bits=64)

        def slice_and_read():
            return sha256_block.slice_launch(scratch, 0, count, 64)()

        def step():
            sha256_block.step(scratch, data=data, height=2,
                              difficulty_bits=64, nonce_out=nonce)

        def whole_round():
            winner_select(*slice_and_read(), group)
            sha256_block.put_result(scratch, 1, 5)
            step()

        pieces = {"slice_and_read": slice_and_read,
                  "winner_select": lambda: winner_select(1, 5, group),
                  "put_result": lambda: sha256_block.put_result(scratch, 1,
                                                                5),
                  "step": step, "round": whole_round}
        out = {}
        for name, fn in pieces.items():
            times = []
            for _ in range(reps):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e6)
            out[f"{name}_us"] = statistics.median(times)
        return out
    finally:
        dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_blockchain_tpu_torch.tools.world_turns",
        description="the fused and per-block gloo worlds in turns, and "
                    "the fused world's round priced piece by piece")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke

    runs = []
    for _ in range(args.rounds):
        for form in ORDER:
            run = world_run(form)
            runs.append(run)
            print(json.dumps(run), flush=True)
    medians = {form: statistics.median(r["wall_s"] for r in runs
                                       if r["form"] == form)
               for form in FORMS}
    cost = round_cost()
    print(json.dumps({"runs": runs, "median_wall_s": medians,
                      "round_cost": cost,
                      "card": chip_smoke.nvidia_smi("name,power.limit")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
