"""The benchmark's yardstick: spans around calls into the program, the
profiler window and its reading, and the card's peak rates."""
