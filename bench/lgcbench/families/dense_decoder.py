"""The llama-architecture decoder as the program's ``ModelConfig``."""


def port_config(cfg):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
        rms_norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        dtype=cfg["torch_dtype"], source=cfg["source"])
