"""PyTorch/CUDA port of `egohmr_tpu` for one NVIDIA H100.

It carries stage-2 inference (unguided and collision-guided DDIM-5 and
DDPM-50 sampling, entered through `serving.Predictor`), the stage-2
evaluation path (`eval.test_egohmr`, with the EgoBody dataset, the metrics and
the renderer), stage-2 training (`train.train_egohmr`, with resumable
checkpoints), stage 1 (the conditional Glow flow of `models.prohmr`, its
evaluation CLI `eval.test_prohmr`, whose translations stage 2 takes, and its
GAN training CLI `train.train_prohmr`), the learned collision backends
(the distilled occupancy and signed-distance nets of `collision`, their
distillation CLIs `train.distill_occupancy` and `train.distill_sdf`, the
COAP/VolumetricSMPL converters of `interop`, and `eval.test_egohmr_volsmpl`),
the scene preprocessing (`preprocess`), data parallelism over processes
and the tensor-parallel split of inference over a data x model grid of
devices (`parallel`), and the tensor-core rate probe
(`tools.probe_int8_mma`). The
package imports `torch`, NumPy, SciPy and PIL only, never JAX and never
`egohmr_tpu`, so it runs on a machine without JAX.

Nothing is imported eagerly here: the hand-written CUDA kernels (under
`csrc/`) are compiled with `nvcc` on first use, by the wrapper that launches
them (`_build.py`).
"""
