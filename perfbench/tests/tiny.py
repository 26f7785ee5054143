"""Tiny configurations of the benchmark's two families, for CPU tests."""

COEF = {"name": "coef-tiny", "family": "coefficient_tuning",
        "task": {"n_documents": 200, "n_features": 300, "n_classes": 5, "label_skew": 0.8, "train_per_node": 6,
                 "val_per_node": 4},
        "nodes": 4, "topology": "ring", "dtype": "float32",
        "c2dfb": {"lam": 10.0, "eta_out": 0.5, "gamma_out": 0.5, "eta_in": 0.1, "gamma_in": 0.5}}

LM = {"name": "lm-tiny", "family": "lm_bilevel", "dtype": "bfloat16",
      "model": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4, "num_key_value_heads": 4,
                "num_hidden_layers": 2, "vocab_size": 128, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
                "tie_word_embeddings": False, "initializer_range": 0.02},
      "c2dfb": {"lam": 10.0, "eta_out": 0.0003, "gamma_out": 0.5, "eta_in": 0.0009, "gamma_in": 0.5}}


def coef_workload(compressor: str = "kernel_topk", K: int = 3) -> dict:
    return {"c2dfb": {"K": K, "compressor": compressor, "comp_ratio": 0.2, "comp_bits": 4, "comp_block": 128},
            "trace_rounds": 2}


def lm_workload(K: int = 2, batch: int = 2, seq_len: int = 16, nodes: int = 4) -> dict:
    return {"nodes": nodes, "topology": "ring",
            "tokens": {"batch": batch, "seq_len": seq_len, "zipf_a": 1.2, "follow": 0.5},
            "c2dfb": {"K": K, "compressor": "kernel_topk", "comp_ratio": 0.2, "comp_block": 128},
            "trace_rounds": 2}
