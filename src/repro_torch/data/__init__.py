from repro_torch.data.pipeline import synthetic_token_batches

__all__ = ["synthetic_token_batches"]
