"""The Moonlight QAT cell at CPU size, added to a copy of the benchmark as a
later change adds one (a configuration, a mix, a cell and its names in the
metrics' lists: new files and entries only): the program against the
plain reference, the int4 control and the two faults the comparison has
to catch, and the MoE layer's per-layer metrics."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import calibrate, harness, testing

CELL, BIG = "moonlight.smoke", "moonlight.qat-b1s8192"

#: The smoke model: every published key at a CPU size, 4 of 16 experts held.
SMALL = {"hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 4,
         "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
         "v_head_dim": 16, "intermediate_size": 192, "moe_intermediate_size": 32,
         "n_routed_experts": 4, "num_experts_per_tok": 4, "num_hidden_layers": 3,
         "vocab_size": 512}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def moonlight_smoke_root(dest: Path) -> Path:
    root = testing.smoke_root(dest)
    pb = root / "perfbench"
    conf = json.loads((pb / "configs" / "moonlight_16b_qat.json").read_text())
    conf.update(SMALL, name="moonlight_smoke", held_first=4)
    conf["published"] = {"n_routed_experts": 16, "vocab_size": 512}
    # one attention chunk, so the program's forward is the reference's; a
    # faster bias (0.02 a step), so its effect shows over 96 tokens
    conf["training"].update(attn_chunk=128, attn_block=128, bias_rate=0.02)
    # limits of this size, from calibrate.readings on the CPU (one thread)
    # over 16 seeds, loss / grad / change / count / pull: the program read
    # at most 1.8e-3 / 1.4e-3 / 2.9e-3 / 0.016 / 2.6e-3; the int4 control at
    # least 9.6e-3 / 0.11 / 0.021 / 0.17; the bias ignored 5.4e-4 / 0 /
    # 2.4e-3 / 0.070 / 0.094; the shared experts left out 6.1e-3 / 1 / 0.99
    # / 0.19
    conf["check"] = {"loss_gap": 4e-3, "grad_norm_gap": 0.01, "change_norm_gap": 8e-3,
                     "count_gap": 0.035, "pull_gap": 0.03}
    _write(pb / "configs" / "moonlight_smoke.json", conf)
    mix = json.loads((pb / "traffic" / "qat_b1s8192.json").read_text())
    mix.update(name="moonlight_tokens_smoke", seq_len=96)
    _write(pb / "traffic" / "moonlight_tokens_smoke.json", mix)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "moonlight_smoke", "file": "perfbench/configs/moonlight_smoke.json",
                           "source": "https://huggingface.co/moonshotai/Moonlight-16B-A3B",
                           "reduced": ["n_routed_experts", "vocab_size"], "why": "CPU test size"})
    man["workloads"].append({"name": CELL, "config": "moonlight_smoke",
                             "traffic": "moonlight_tokens_smoke", "chips": 1,
                             "why": "CPU test size"})
    for m in man["end_to_end"] + man["per_layer"]:
        if BIG in m.get("workloads", []):
            m["workloads"].append(CELL)
    _write(root / "BENCHMARK.json", man)
    return root


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return moonlight_smoke_root(tmp_path_factory.mktemp("moonlight"))


def run(root, **kw):
    return harness.run_cell(CELL, kw.pop("seed", 2**31 + 41), kw.pop("seconds", 3.0),
                            kw.pop("trace", False), root=root, device="cpu", **kw)


def test_the_cell_is_found_without_editing_a_file(root):
    for rel in ("perfbench/harness.py", "perfbench/testing.py", "perfbench/runners/lm_qat.py",
                "perfbench/configs/yi_6b_qat.json", "perfbench/traffic/qat_b8s512.json"):
        assert (root / rel).read_bytes() == (harness.ROOT / rel).read_bytes()
    cell = harness.resolve(CELL, root)
    assert cell.config["runner"] == "mla_moe_qat" and cell.mix["seq_len"] == 96
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s", "setup_s"}
    assert {"moe_route_host_ms", "moe_experts_host_ms", "moe_expert_rows"} <= {
        m["name"] for m in cell.per_layer}


def test_the_cells_configuration_is_the_catalogs_with_the_cut():
    conf = json.loads((harness.ROOT / "perfbench" / "configs" /
                       "moonlight_16b_qat.json").read_text())
    man = harness.load_manifest()
    entry = {c["name"]: c for c in man["configs"]}["moonlight_16b_qat"]
    assert entry["reduced"] == ["n_routed_experts", "vocab_size"]
    assert (conf["n_routed_experts"], conf["vocab_size"]) == (8, 20_480)
    assert conf["published"] == {"n_routed_experts": 64, "vocab_size": 163_840}
    assert (conf["num_hidden_layers"], conf["hidden_size"], conf["moe_intermediate_size"],
            conf["kv_lora_rank"], conf["num_experts_per_tok"]) == (27, 2048, 1408, 512, 6)


def test_the_cell_runs_and_is_correct(root):
    out = run(root)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_a_traced_run_reads_the_moe_layer(root):
    out = run(root, trace=True)
    assert out["correct"] is True
    m = out["metrics"]
    assert {"moe_route_host_ms", "moe_experts_host_ms", "moe_expert_rows", "train_mfu"} <= set(m)
    assert 0 < m["moe_expert_rows"]["value"] <= 96 * 4
    assert "train_mma_roofline" not in m  # no card, no kernel launch to read
    from repro_torch.obs import timeline

    counts = timeline.last().counts
    assert counts["moe.dropped"] == 0 and counts["moe.count_reads"] == counts["moe.calls"]


def test_the_control_and_both_faults_fail_a_limit(root):
    r = calibrate.readings(CELL, 2**31 + 43, 1.0, device="cpu", root=root)
    lim = harness.resolve(CELL, root).config["check"]
    assert all(r[f"program.{k}"] <= v for k, v in lim.items()), r
    for fault in ("control_int4", "fault_no_bias", "fault_no_shared"):
        assert any(r[f"{fault}.{k}"] > v for k, v in lim.items()), (fault, r)


def test_the_parent_without_the_model_fails_at_once(root, monkeypatch):
    """A program without ``moonlight_16b_a3b`` (the commit before it) stops
    in set-up with an ImportError, which ``run.py`` turns into exit 3."""
    from repro_torch import configs

    def missing(name):
        raise ModuleNotFoundError(f"No module named 'repro_torch.configs.{name}'")

    monkeypatch.setattr(configs, "get_config", missing)
    with pytest.raises(ImportError):
        run(root)
