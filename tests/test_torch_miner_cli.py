"""The port's ``mine``/``verify``/``info`` against the reference CLI.

``mine --device cpu --out`` must write the same bytes as the reference's
``mine --backend cpu --out``, for the pipelined and the sequential
drivers; the device policy must fail cleanly instead of moving to the CPU.
"""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from mpi_blockchain_tpu.cli import main as ref_main
from mpi_blockchain_tpu_torch.cli import main
from mpi_blockchain_tpu_torch.config import ConfigError, MinerConfig
from mpi_blockchain_tpu_torch.models.miner import Miner

# The suite runs in several worker processes at once; torch's per-op
# thread pools in each would oversubscribe the cores many times over.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PINNED_D16_N30 = \
    "0000920e5985e6c7571d5094847875c2fa96ee43cff93294339fc12283597371"


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_mine_out_bytes_match_reference(tmp_path, monkeypatch, capsys,
                                        pipeline):
    monkeypatch.setenv("MPIBT_PIPELINE", pipeline)
    ours, ref = tmp_path / "port.bin", tmp_path / "ref.bin"
    assert main(["mine", "--device", "cpu", "--difficulty", "12",
                 "--blocks", "5", "--out", str(ours)]) == 0
    summary = _last_json(capsys)
    assert summary["kernel"] == "torch" and summary["height"] == 5
    assert ref_main(["mine", "--backend", "cpu", "--difficulty", "12",
                     "--blocks", "5", "--out", str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes()
    assert summary["tip_hash"] == _last_json(capsys)["tip_hash"]


def test_verify_accepts_and_rejects(tmp_path, capsys):
    chain = tmp_path / "c.bin"
    assert main(["mine", "--backend", "cpu", "--difficulty", "12",
                 "--blocks", "5", "--out", str(chain)]) == 0
    tip = _last_json(capsys)["tip_hash"]
    assert main(["verify", "--chain", str(chain), "--difficulty", "12"]) == 0
    out = _last_json(capsys)
    assert out["valid"] and out["height"] == 5 and out["tip_hash"] == tip
    assert main(["verify", "--chain", str(chain), "--difficulty", "13"]) == 1
    assert _last_json(capsys)["valid"] is False
    blob = bytearray(chain.read_bytes())
    blob[3 * 80 + 40] ^= 0x01              # block 3's data hash
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes(blob))
    assert main(["verify", "--chain", str(bad), "--difficulty", "12"]) == 1
    assert _last_json(capsys)["valid"] is False
    assert main(["verify", "--chain", str(tmp_path / "missing.bin"),
                 "--difficulty", "12"]) == 1
    assert "error" in _last_json(capsys)


def test_cuda_kernel_on_cpu_is_a_clean_config_error(capsys):
    assert main(["mine", "--kernel", "cuda", "--device", "cpu",
                 "--difficulty", "8", "--blocks", "1"]) == 2
    out = _last_json(capsys)
    assert out["event"] == "error" and "kernel='cuda'" in out["error"]


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        Miner(MinerConfig(difficulty_bits=8, n_blocks=1))
    assert main(["mine", "--difficulty", "8", "--blocks", "1"]) == 2
    assert "no CUDA device" in _last_json(capsys)["error"]


def test_sequential_and_pipelined_drivers_agree():
    cfg = MinerConfig(difficulty_bits=11, n_blocks=4, device="cpu")
    seq, pipe = Miner(cfg, pipeline=False), Miner(cfg, pipeline=True)
    seq.mine_chain()
    pipe.mine_chain()
    assert seq.node.save() == pipe.node.save()
    assert [(r.nonce, r.hashes_tried) for r in seq.records] \
        == [(r.nonce, r.hashes_tried) for r in pipe.records]


def test_pinned_d16_n30_tip_on_the_cpu_backend(capsys):
    assert main(["mine", "--backend", "cpu", "--difficulty", "16",
                 "--blocks", "30"]) == 0
    assert _last_json(capsys)["tip_hash"] == PINNED_D16_N30


def test_info_reports_the_toolchain(capsys):
    assert main(["info"]) == 0
    out = _last_json(capsys)
    assert out["torch"] == torch.__version__
    assert {"torch_cuda", "cuda_available", "device_name", "nvcc"} <= set(out)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
