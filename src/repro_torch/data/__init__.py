from repro_torch.data.pipeline import (synthetic_image_batches,
                                      synthetic_token_batches,
                                      text_file_token_batches)

__all__ = ["synthetic_image_batches", "synthetic_token_batches",
           "text_file_token_batches"]
