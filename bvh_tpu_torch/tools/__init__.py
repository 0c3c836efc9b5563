"""The port's tools, counterparts of the JAX package's tools
(`tools/*.py`), each under its file name. This layer sits above the CLI,
build and traverse layers and drives their entry points.

The profilers of the tools that launch Pallas kernels:

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

The tools for building, rendering and dims, which hold no kernel of
their own:

- `bench_build`: Mprims/s of lbvh, the level-synchronous mini-tree,
  binned, mtf (kernel B3) and high (mtf plus reinsertion);
- `profile_mtf`: `build_minitree_fast` stage by stage, through its
  `stage` runner;
- `profile_reinsertion`: one reinsertion iteration stage by stage,
  through `_one_iteration`'s `stage` runner, with each stage's share
  and host syncs;
- `profile_build`: the builders' primitive operations, a binned round
  and the full binned and mini-tree builds;
- `check_mtf_parity`: the two mini-tree builds bit-equal at scale;
- `bench_wide`: the render across treelet sizes;
- `check_wide_quick`, `check_super_quick`: the 262K render's hits
  (81,790), flat and with a forced super level;
- `bench_sanmiguel`: the 10M two-level render and the serialize round
  trip of its tree;
- `ablate_kernel2`: B1's variants on the real round-1 pairs;
- `bench_dims`: 2D-4D spheres through B6 with the wavefront parity
  gate, and float64 triangles.

The last five, for the render's per-ray gate and the launch and glue
costs around the kernels:

- `check_oracle`: the render of the native library's tree against a
  per-ray tracer over the repo's native/bvh_c.cpp (`oracle_trace.cpp`),
  fast and robust, within 4 rays a million;
- `profile_floor`: the card's launch floor, eager loops of torch ops
  against their CUDA-graph replays;
- `profile_floor2`: the builders' and the render's glue ops at 262K
  (gathers, scatters, fills, scans, sorts, the dim-0 cumsum and its
  transposed form);
- `profile_pure`: a render's device-only time from a trace, against
  its event time, one render and four back to back;
- `sweep_chain`: the render over treelet sizes and portals a round,
  timed beside the entry point's render, every config's hits equal to
  the default's.

Each runs as `python -m bvh_tpu_torch.tools.<name>`, on the card unless
given `--device cpu` (use small sizes there: each docstring gives
them), and exposes a `run(..., device=)` that returns its results
beside its times. Times are CUDA events (`timing.py`), the first call
reported apart, and the last output of every timed loop is compared
with the verified one. A failed check raises or, from the command
line, exits 1. Importing a module does no work.
"""
