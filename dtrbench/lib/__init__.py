"""The benchmark's yardstick: data, weights, work arithmetic, profiling,
statistics and the comparison that decides ``correct``.  Later changes to
the program do not change these files."""
