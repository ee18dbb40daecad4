"""Driver of DNN batch scoring: one caller scores host Tables of token
ids through `DeepModelTransformer.transform` of the port's
`TransformerEncoder`, call after call, fetching logits and probability.

Weights are made on the device from the seed (inputs/encoder.py) and
loaded into the port's model by name; a pool of token tables, made on the
device from the seed, is scored in turn. The output check draws rows of
the window's calls from the seed and runs the plain float32 reference
(reference/bert.py) over them with the same weights, made again."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.inputs import encoder
from perfbench.reference import bert as ref

MODEL_KEYS = ("num_layers", "d_model", "num_heads", "d_ff", "num_outputs", "vocab_size",
              "max_len", "attention_impl", "dtype")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.outputs: list = []

    def setup(self, warm: bool = True) -> None:
        from mmlspark_tpu_torch.core import Table
        from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle
        from mmlspark_tpu_torch.nn.carry import module_variables
        from mmlspark_tpu_torch.nn.models import make_model

        t = self.traffic
        model_cfg = {k: self.cfg[k] for k in MODEL_KEYS}
        module = make_model("transformer", (t["tokens"],), **model_cfg)
        weights = encoder.make_weights(self.cfg, self.seed, self.device)
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(weights[name].cpu())
        del weights
        bundle = ModelBundle(architecture="transformer", config=model_cfg,
                             variables=module_variables(module), input_shape=(t["tokens"],))
        del module
        self.stage = DeepModelTransformer(
            input_col="tokens", mini_batch_size=t["mini_batch_size"], device=self.device,
            fetch_dict={"logits": "logits", "prob": "probability"}, bfloat16=False,
        ).set_model(bundle)
        self.ids = encoder.token_ids(t["pool"], t["rows"], t["tokens"], self.cfg["vocab_size"],
                                     self.seed, self.device).cpu().numpy()
        self.pool = [Table({"tokens": ids}) for ids in self.ids]
        if warm:
            for _ in range(2):
                self.stage.transform(self.pool[0])

    def call(self, i: int) -> dict:
        out = self.stage.transform(self.pool[i % len(self.pool)])
        self.outputs.append((i % len(self.pool), out["logits"], out["prob"]))
        t = self.traffic
        return {"rows": t["rows"], "tokens": t["rows"] * t["tokens"]}

    def release(self) -> None:
        self.stage = None
        self.pool = None

    def sample(self) -> list[tuple[int, int]]:
        """(call, row) pairs drawn from the seed over the window's calls."""
        rng = np.random.default_rng([self.seed, 17])
        n = len(self.outputs) * self.traffic["rows"]
        picks = rng.choice(n, size=min(self.traffic["check_rows"], n), replace=False)
        return [divmod(int(p), self.traffic["rows"]) for p in np.sort(picks)]

    def reference(self, pairs, gemm=ref.f32_gemm) -> np.ndarray:
        w = encoder.make_weights(self.cfg, self.seed, self.device)
        ids = np.stack([self.ids[self.outputs[c][0]][r] for c, r in pairs])
        block = self.traffic["check_block"]
        with torch.no_grad():
            out = [ref.forward(w, self.cfg, torch.as_tensor(ids[i:i + block],
                                                            device=self.device), gemm)
                   for i in range(0, len(ids), block)]
        return torch.cat(out).double().cpu().numpy()

    def check(self, got: np.ndarray | None = None) -> dict:
        pairs = self.sample()
        want = self.reference(pairs)
        if got is None:
            got = np.stack([self.outputs[c][1][r] for c, r in pairs]).astype(np.float64)
            prob = np.stack([self.outputs[c][2][r] for c, r in pairs]).astype(np.float64)
        else:
            prob = _softmax(got)
        return {"logit_gap": float(np.abs(got - want).max() / np.abs(want).max()),
                "prob_gap": float(np.abs(prob - _softmax(want)).max())}

    def control(self) -> dict:
        """The reference with every product in float8 e4m3, in the
        program's place."""
        return self.check(self.reference(self.sample(), ref.fp8_gemm))


def _softmax(z: np.ndarray) -> np.ndarray:
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)
