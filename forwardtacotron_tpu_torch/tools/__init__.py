"""Operator tools of the port, each run as
`python -m forwardtacotron_tpu_torch.tools.<tool>` (the counterparts of the
repository's `tools/` scripts, which need the JAX package):

- `benchmark_serving`: N client threads x M requests against `TTSServer`;
  latency percentiles, throughput and the kernels' launches as one JSON
  line;
- `average_checkpoints`: the float weights of k checkpoints averaged into
  one;
- `model_info`: a checkpoint's or export artifact's model, step,
  parameter count and config;
- `export_torch`: a reference-format `.pt`, or the official HiFi-GAN
  generator file, from any checkpoint;
- `f0_bound`: the F0 tracker against the speech fixture's contour and an
  independent YIN;
- `make_synthetic_dataset`: a tiny preprocessed dataset for end-to-end
  runs.

`checkpoint_files` reads every checkpoint format the tools take.
"""
