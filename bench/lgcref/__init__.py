"""The plain reference of the benchmark's cells, in plain PyTorch and
computed in float32 with TF32 off: each family's training loss
(``dense_decoder``, ``mamba2``), the LGC autoencoder (``ae``) and one
training step of K data-parallel nodes (``lgc``): each node's loss and
gradient, the error-feedback accumulate, the per-leaf top-k, the
autoencoder's training, encode and decode, the node mean, the int8 wire
where the cell's transport ships one, and AdamW.

It imports nothing of the program under test and takes nothing the
program has made: the benchmark hands both sides the same weights and
batches, and the reference works out every state (error feedback,
autoencoder, optimizer) itself from them."""
