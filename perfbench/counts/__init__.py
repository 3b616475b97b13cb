"""The benchmark's frozen yardstick: the chip's peaks, the operations
and bytes the MM estimate needs, and the model FLOPs of a train step."""
