"""A new cell, traffic mix, configuration and per-layer metric are added
as files and BENCHMARK.json entries alone: in a copy of the benchmark
with such files added, the harness finds each by its name."""

import json
import shutil
from pathlib import Path

from perfbench import harness
from perfbench.tests._tiny import SEED, TINY

PB = Path(__file__).resolve().parents[1]


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((PB.parent / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "bert_base.json").read_text())
    cfg.update(name="bert_small", **TINY["bert_base.score_512"]["config"])
    (pb / "configs" / "bert_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "score_512.json").read_text())
    traffic.update(TINY["bert_base.score_512"]["traffic"], rows=4)
    (pb / "traffic" / "score_tiny.json").write_text(json.dumps(traffic))
    spec = {"config": "bert_small", "traffic": "score_tiny", "chips": 1, "why": "a test",
            "limits": {"logit_gap": 0.055, "prob_gap": 0.012}}
    (pb / "workloads" / "bert_small.tiny.json").write_text(json.dumps(spec))
    (pb / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    man["workloads"].append({"name": "bert_small.tiny", "config": "bert_small",
                             "traffic": "score_tiny", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] in ("score_tokens_per_s", "score_p95_ms"):
            m["workloads"].append("bert_small.tiny")
    man["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                             "source": "host_clock", "layer": "dnn runner",
                             "moves": "score_tokens_per_s", "workloads": ["bert_small.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    result, checks = harness.run_cell("bert_small.tiny", SEED, 0.2, False, device="cpu",
                                      pb=pb, root=root)
    assert result["correct"] and [c[0] for c in checks] == ["logit_gap", "prob_gap"]
    assert set(result["metrics"]) == {"score_tokens_per_s", "score_p95_ms", "setup_s"}
    traced, _ = harness.run_cell("bert_small.tiny", SEED, 0.2, True, device="cpu",
                                 pb=pb, root=root)
    assert traced["metrics"]["calls_seen"]["value"] == traced["attempted"]
