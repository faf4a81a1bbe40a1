"""The port's sealed checkpoints against the reference's, on the CPU.

The same chain saved by either package gives the same sealed file byte for
byte (and sidecars equal but for the config each package records); each
package loads the other's file; a torn, bitrotted or legacy file behaves
as it does in the reference (same recovered height, same dropped bytes);
and ``mine --checkpoint/--resume`` and ``verify`` of sealed files work
through the port's CLI.
"""
import json

import pytest
import torch

from mpi_blockchain_tpu import core as ref_core
from mpi_blockchain_tpu.cli import main as ref_main
from mpi_blockchain_tpu.resilience import injection as ref_injection
from mpi_blockchain_tpu.utils import checkpoint as ref_ckpt
from mpi_blockchain_tpu_torch import core, telemetry
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner
from mpi_blockchain_tpu_torch.resilience import FaultInjected, injection
from mpi_blockchain_tpu_torch.resilience.faultplan import FaultPlan
from mpi_blockchain_tpu_torch.utils import checkpoint as ckpt
from mpi_blockchain_tpu_torch.utils.checkpoint import (CheckpointError,
                                                       load_chain,
                                                       open_checkpoint,
                                                       recover_chain,
                                                       save_chain)

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarmed():
    injection.disarm()
    ref_injection.disarm()
    telemetry.reset()
    telemetry.clear_events()
    yield
    injection.disarm()
    ref_injection.disarm()


def _mined(n=3, difficulty=8) -> Miner:
    miner = Miner(MinerConfig(difficulty_bits=difficulty, n_blocks=n,
                              backend="cpu"))
    miner.mine_chain()
    return miner


def _ref_node(node: core.Node) -> ref_core.Node:
    """The same chain in the reference's C++ node."""
    ref = ref_core.Node(node.difficulty_bits, 0)
    assert ref.load(node.save())
    return ref


def _save_both(tmp_path, n=3):
    """One chain saved by each package: (port path, reference path)."""
    miner = _mined(n)
    ours, ref = tmp_path / "port" / "ck.bin", tmp_path / "ref" / "ck.bin"
    ours.parent.mkdir()
    ref.parent.mkdir()
    save_chain(miner.node, ours, miner.config)
    ref_ckpt.save_chain(_ref_node(miner.node), ref, {"difficulty_bits": 8})
    return ours, ref


def _sidecar(path) -> dict:
    return json.loads(path.with_suffix(".bin.json").read_text())


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sealed_file_is_byte_identical_to_the_references(tmp_path):
    ours, ref = _save_both(tmp_path)
    assert ours.read_bytes() == ref.read_bytes()
    assert ckpt.MAGIC == ref_ckpt.MAGIC
    assert ckpt.TRAILER_SIZE == ref_ckpt.TRAILER_SIZE == 48
    a, b = _sidecar(ours), _sidecar(ref)
    assert a.pop("config")["backend"] == "cpu"
    b.pop("config")
    assert a == b
    assert a["checkpoint_version"] == 2
    assert a["payload_len"] == 4 * core.HEADER_SIZE
    assert not list(tmp_path.rglob("*.tmp.*")), "tmp file left behind"


def test_each_package_loads_the_others_file(tmp_path):
    ours, ref = _save_both(tmp_path)
    port_node = load_chain(ref, 8)
    ref_node = ref_ckpt.load_chain(ours, 8)
    assert port_node.height == ref_node.height == 3
    assert port_node.tip_hash == ref_node.tip_hash


@pytest.mark.parametrize("cut", [48, 100, 120, 2 * 48 + 80, 80 * 3 + 48])
def test_torn_tail_recovers_as_the_reference_does(tmp_path, cut):
    ours, ref = _save_both(tmp_path, n=4)
    for path in (ours, ref):
        path.write_bytes(path.read_bytes()[:-cut])
    with pytest.raises(CheckpointError):
        load_chain(ours, 8)
    node, report = recover_chain(ours, 8)
    ref_node, ref_report = ref_ckpt.recover_chain(ref, 8)
    assert report["recovered"] is ref_report["recovered"] is True
    assert (node.height, report["height"], report["dropped_bytes"]) == (
        ref_node.height, ref_report["height"], ref_report["dropped_bytes"])
    # The repaired files are rewritten sealed, identically.
    assert ours.read_bytes() == ref.read_bytes()
    assert load_chain(ours, 8).height == node.height
    assert telemetry.counter("checkpoint_recoveries_total").value == 1
    truncated = telemetry.recent_events(event="checkpoint_truncated")[-1]
    assert truncated["height"] == node.height


@pytest.mark.parametrize("where", [100, -1, -45])
def test_bitrot_behaves_as_in_the_reference(tmp_path, where):
    """Bitrot in the payload, in the trailer's digest, in its length."""
    ours, ref = _save_both(tmp_path)
    for path in (ours, ref):
        rotted = bytearray(path.read_bytes())
        rotted[where] ^= 0x01
        path.write_bytes(bytes(rotted))
    with pytest.raises(CheckpointError):
        load_chain(ours, 8)
    with pytest.raises(ref_ckpt.CheckpointError):
        ref_ckpt.load_chain(ref, 8)
    node, report = recover_chain(ours, 8)
    ref_node, ref_report = ref_ckpt.recover_chain(ref, 8)
    assert (node.height, report["dropped_bytes"]) == (
        ref_node.height, ref_report["dropped_bytes"])


def test_legacy_file_still_loads(tmp_path):
    miner = _mined()
    path = tmp_path / "legacy.bin"
    path.write_bytes(miner.node.save())   # raw headers, no trailer/sidecar
    node = load_chain(path, 8)
    assert node.height == 3 and node.tip_hash == miner.node.tip_hash
    assert open_checkpoint(path)[1] is False
    assert ref_ckpt.load_chain(path, 8).tip_hash == node.tip_hash
    node, report = recover_chain(path, 8)
    assert report == {"recovered": False, "height": 3, "dropped_bytes": 0}


def test_torn_tail_on_a_header_boundary_is_rejected(tmp_path):
    miner = _mined()
    path = tmp_path / "chain.bin"
    save_chain(miner.node, path, miner.config)
    blob = path.read_bytes()
    # A tear on an 80-byte boundary must not load as a shorter chain.
    path.write_bytes(blob[:2 * core.HEADER_SIZE])
    with pytest.raises(CheckpointError, match="torn"):
        load_chain(path, 8)
    path.write_bytes(blob[:len(blob) - 100])
    with pytest.raises(CheckpointError):
        load_chain(path, 8)


def test_recover_chain_refuses_difficulty_mismatch(tmp_path):
    miner = _mined()
    path = tmp_path / "chain.bin"
    save_chain(miner.node, path, miner.config)
    with pytest.raises(ConfigError, match="difficulty"):
        recover_chain(path, 16)


def test_checkpoint_write_faults(tmp_path):
    miner = _mined()
    path = tmp_path / "chain.bin"
    save_chain(miner.node, path, miner.config)   # a prior good save
    injection.arm(FaultPlan.from_dict({"version": 1, "faults": [
        {"site": "checkpoint.write", "kind": "partial"},
        {"site": "checkpoint.write", "kind": "corrupt", "call": 1}]}))
    with pytest.raises(FaultInjected):
        save_chain(miner.node, path, miner.config)
    with pytest.raises(CheckpointError):
        load_chain(path, 8)
    node, report = recover_chain(path, 8)      # rewrites: call 1, rotted
    assert report["recovered"] is True and node.height >= 0
    with pytest.raises(CheckpointError):
        load_chain(path, 8)
    injection.disarm()
    node, report = recover_chain(path, 8)
    assert report["recovered"] is True


@pytest.mark.parametrize("kind", ["corrupt", "partial", "raise"])
def test_checkpoint_read_faults(tmp_path, kind):
    miner = _mined()
    path = tmp_path / "chain.bin"
    save_chain(miner.node, path, miner.config)
    injection.arm(FaultPlan.from_dict({"version": 1, "faults": [
        {"site": "checkpoint.read", "kind": kind}]}))
    with pytest.raises(FaultInjected if kind == "raise"
                       else CheckpointError):
        load_chain(path, 8)
    # The damage was in flight: the file itself is whole.
    assert load_chain(path, 8).tip_hash == miner.node.tip_hash


def test_recover_seal_only_damage_reports_zero_dropped(tmp_path):
    miner = _mined()
    path = tmp_path / "chain.bin"
    save_chain(miner.node, path, miner.config)
    path.write_bytes(path.read_bytes()[:-48])   # only the trailer goes
    node, report = recover_chain(path, 8)
    assert report["recovered"] is True
    assert report["dropped_bytes"] == 0 and node.height == 3


def test_sidecar_nonnumeric_version_is_checkpoint_error(tmp_path):
    miner = _mined()
    path = tmp_path / "chain.bin"
    save_chain(miner.node, path, miner.config)
    sidecar = tmp_path / "chain.bin.json"
    meta = json.loads(sidecar.read_text())
    meta["checkpoint_version"] = "two"
    del meta["payload_sha256"]
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(CheckpointError, match="checkpoint_version"):
        load_chain(path, 8)
    node, report = recover_chain(path, 8)
    assert node.height == 3 and report["dropped_bytes"] == 0


def test_recover_preserves_sidecar_config(tmp_path):
    miner = _mined()
    path = tmp_path / "chain.bin"
    save_chain(miner.node, path, miner.config)
    path.write_bytes(path.read_bytes()[:-120])
    recover_chain(path, 8)
    meta = json.loads((tmp_path / "chain.bin.json").read_text())
    assert meta["config"]["difficulty_bits"] == 8
    assert meta["config"]["data_prefix"] == "block"


# ---- the CLI ----------------------------------------------------------------


def test_cli_checkpoint_equals_the_references(tmp_path, capsys):
    ours, ref = tmp_path / "port.bin", tmp_path / "ref.bin"
    assert main(["mine", "--difficulty", "8", "--blocks", "3", "--backend",
                 "cpu", "--checkpoint", str(ours)]) == 0
    assert ref_main(["mine", "--difficulty", "8", "--blocks", "3",
                     "--backend", "cpu", "--checkpoint", str(ref)]) == 0
    capsys.readouterr()
    assert ours.read_bytes() == ref.read_bytes()
    for path in (ours, ref):
        for verify in (main, ref_main):
            assert verify(["verify", "--chain", str(path), "--difficulty",
                           "8"]) == 0
            out = _last_json(capsys)
            assert out["valid"] is True and out["sealed"] is True
            assert out["height"] == 3


@pytest.mark.parametrize("every", [1, 2])
def test_cli_checkpoint_every_saves_as_it_mines(tmp_path, capsys, every):
    ck = tmp_path / "ck.bin"
    assert main(["mine", "--difficulty", "8", "--blocks", "4", "--backend",
                 "cpu", "--checkpoint", str(ck), "--checkpoint-every",
                 str(every)]) == 0
    saved = [e["height"] for e in
             telemetry.recent_events(event="checkpoint_saved")]
    assert saved == [h for h in range(1, 5) if h % every == 0] + [4]
    assert load_chain(ck, 8).height == 4


def test_cli_resume_replays_heartbeat_and_event(tmp_path, capsys):
    ck = tmp_path / "ck.bin"
    assert main(["mine", "--difficulty", "8", "--blocks", "2", "--backend",
                 "cpu", "--checkpoint", str(ck)]) == 0
    capsys.readouterr()
    assert main(["mine", "--difficulty", "8", "--blocks", "3", "--backend",
                 "cpu", "--resume", str(ck)]) == 0
    assert _last_json(capsys)["height"] == 3
    resumed = telemetry.recent_events(event="checkpoint_resumed")
    assert resumed and resumed[-1]["height"] == 2
    hb = telemetry.default_registry().gauge("miner_heartbeat")
    assert hb.value == 3 and hb.age_s() is not None


def test_cli_resume_of_the_references_checkpoint(tmp_path, capsys):
    """A run the reference checkpointed resumes in the port (on its torch
    sweep) to the chain the reference mines straight through."""
    ck, out = tmp_path / "ck.bin", tmp_path / "out.bin"
    assert ref_main(["mine", "--difficulty", "9", "--blocks", "2",
                     "--backend", "cpu", "--checkpoint", str(ck)]) == 0
    assert main(["mine", "--difficulty", "9", "--blocks", "5", "--device",
                 "cpu", "--resume", str(ck), "--out", str(out)]) == 0
    ours = _last_json(capsys)
    assert ref_main(["mine", "--difficulty", "9", "--blocks", "5",
                     "--backend", "cpu"]) == 0
    assert ours["tip_hash"] == _last_json(capsys)["tip_hash"]
    assert ours["height"] == 5


def test_cli_resume_of_a_wrong_difficulty_fails(tmp_path, capsys):
    ck = tmp_path / "ck.bin"
    assert main(["mine", "--difficulty", "8", "--blocks", "1", "--backend",
                 "cpu", "--checkpoint", str(ck)]) == 0
    capsys.readouterr()
    assert main(["mine", "--difficulty", "9", "--blocks", "2", "--backend",
                 "cpu", "--resume", str(ck)]) == 1
    assert "difficulty" in _last_json(capsys)["error"]


def test_cli_verify_rejects_torn_sealed_checkpoint(tmp_path, capsys):
    ck = tmp_path / "ck.bin"
    assert main(["mine", "--difficulty", "8", "--blocks", "3", "--backend",
                 "cpu", "--checkpoint", str(ck)]) == 0
    capsys.readouterr()
    ck.write_bytes(ck.read_bytes()[:2 * core.HEADER_SIZE])
    for verify in (main, ref_main):
        assert verify(["verify", "--chain", str(ck), "--difficulty",
                       "8"]) == 1
        out = _last_json(capsys)
        assert out["valid"] is False and "torn" in out["error"]


def test_cli_fused_checkpoints_at_span_boundaries(tmp_path, capsys):
    ck = tmp_path / "ck.bin"
    assert main(["mine", "--device", "cpu", "--fused", "--blocks-per-call",
                 "2", "--difficulty", "8", "--blocks", "5", "--batch-pow2",
                 "11", "--checkpoint", str(ck), "--checkpoint-every",
                 "1"]) == 0
    out = _last_json(capsys)
    # One span mines all five blocks (no block needed the rollover); the
    # final save follows it.
    saved = [e["height"] for e in
             telemetry.recent_events(event="checkpoint_saved")]
    assert saved == [5, 5]
    assert load_chain(ck, 8).tip_hash.hex() == out["tip_hash"]
