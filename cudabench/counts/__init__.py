"""Work counts of the benchmark's yardstick: kernel bytes and flops, peaks, model FLOPs."""
