"""The frozen yardstick: the H100's published peaks, the kernels' byte and
operation models, and the percentile arithmetic. Later changes to the
program leave these files as they are."""
