"""The harness of the benchmark: it finds a cell's files by name
(``manifest``), draws the weights and the batches from the seed
(``weights``, ``data``), drives the program's training step through a
set-up and a timed window (``harness``), records spans and the device
trace (``spans``, ``trace``), counts the work against the chip's peaks
(``counts``, ``hw``) and decides ``correct`` against the plain reference
(``check``)."""
