"""The benchmark's harness: a run of one cell (`cell`), its two loops
(`train`, `render`), the inputs made from the seed (`scene`), what they
share (`common`), the traced window (`trace`) and the per-layer shares'
arithmetic (`shares`)."""
