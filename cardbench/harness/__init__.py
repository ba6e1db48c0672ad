"""The benchmark's harness: what one run of one cell does, by the names in
``BENCHMARK.json``."""
