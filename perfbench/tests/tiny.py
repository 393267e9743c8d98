"""Small sizes of the cells for runs on the CPU."""

ARCH = {
    "stablelm-12b": {"n_layers": 2, "d_model": 160, "n_heads": 4,
                     "n_kv_heads": 2, "head_dim": 40, "d_ff": 256,
                     "vocab_size": 512},
    "qwen3-moe-30b-a3b": {"n_layers": 2, "d_model": 128, "n_heads": 4,
                          "n_kv_heads": 2, "head_dim": 32, "d_ff": 96,
                          "vocab_size": 512, "n_experts": 8, "top_k": 2},
}
TRAFFIC = {"seq_len": 64, "sample_positions": 32, "sample_block": 16}


def overrides(cell: str, **arch) -> dict:
    config = cell.split(".")[0]
    return {"arch": {**ARCH[config], **arch}, "traffic": TRAFFIC,
            "cell": {"sample_positions": TRAFFIC["sample_positions"]}}
