"""Shared fixtures of the benchmark's own tests: the harness on the path, and
each cell cut to a size the CPU runs in seconds (published widths are for
the card; these keep every key and change only sizes)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CELLS = ("internlm2-1.8b.train_4k", "rwkv6-3b.train_4k", "internlm2-1.8b.prefill_2k-32k",
         "rwkv6-3b.prefill_2k-32k")
TINY_DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16,
              "d_ff": 128, "vocab_size": 256}
TINY_RWKV = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16,
             "d_ff": 128, "vocab_size": 256,
             "rwkv": {"head_size": 16, "decay_lora": 8, "tokenshift_lora": 8}}


def tiny_cell(name: str, dtype: str = "bfloat16"):
    from pbench import harness

    c = harness.load_cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(TINY_RWKV if c.model.get("attention_free") else TINY_DENSE)
    c.config["model"]["dtype"] = dtype
    c.config["train_global_batch"] = 4
    c.traffic = dict(c.traffic)
    if c.traffic["kind"] == "train":
        c.traffic["seq_len"] = 64
    else:
        c.traffic.update(min_len=16, max_len=96, n_lengths=4, len_multiple=8)
    return c


@pytest.fixture
def cuda():
    """Skips a test that needs the card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
