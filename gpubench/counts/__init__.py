"""The benchmark's yardstick: peaks, the work a training step needs, and
the reduction of a traced window."""
