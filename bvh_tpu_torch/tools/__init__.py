"""Profiling tools of the port, counterparts of the JAX package's tools
that launch Pallas kernels (`tools/*.py`), each under its file name:

- `probe_int8_fetch` (T6): the column-fetch probe, kernel
  `column_fetch` (csrc/probes.cu), beside the library's gathers and
  one-hot products;
- `probe_tpu` (T5): the wide-step probe, kernel `wide_step_probe`
  (csrc/probes.cu), and the sorts and gathers of the render's glue;
- `ablate_kernel` (T1): kernel B1's per-step cost on a chain table,
  and its ablation variants (`traverse_pairs_ablate`);
- `profile_r3` (T2): the wide-treelet render stage by stage, and a
  trace of one render;
- `profile_occupancy` (T3): per-pair steps of round 1 and the SIMT
  efficiency of pair orderings;
- `profile_sm` (T4): the San-Miguel-class render's stages at scale.

Each runs as `python -m bvh_tpu_torch.tools.<name>`, on the card unless
given `--device cpu`. Importing a module does no work.
"""
