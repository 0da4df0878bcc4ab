"""The benchmark's harness: the spec, the traffic generator, the frame loop,
the trace reader and the correctness check. Nothing here is specific to one
configuration, traffic mix or per-layer metric; those are files of their own
under ``configs/``, ``scenes/``, ``traffic/`` and ``metrics/``, found by the
names ``BENCHMARK.json`` gives them."""
