"""The Mamba2 decoder as the program's ``ModelConfig``."""


def port_config(cfg):
    from repro_torch.configs.base import MAMBA, ModelConfig, SSMConfig
    return ModelConfig(
        name=cfg["name"], family="ssm",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=cfg["vocab_size"],
        block_pattern=(MAMBA,),
        ssm=SSMConfig(d_state=cfg["state_size"], d_conv=cfg["conv_kernel"],
                      expand=cfg["expand"], head_dim=cfg["head_dim"],
                      chunk_size=cfg["chunk_size"]),
        rms_norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        dtype=cfg["torch_dtype"], source=cfg["source"])
