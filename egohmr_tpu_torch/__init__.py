"""PyTorch/CUDA port of `egohmr_tpu` for one NVIDIA H100.

It carries stage-2 inference (unguided and collision-guided DDIM-5 and
DDPM-50 sampling, entered through `serving.Predictor`), the stage-2
evaluation path (`eval.test_egohmr`, with the EgoBody dataset, the metrics and
the renderer), stage-2 training (`train.train_egohmr`, with resumable
checkpoints) and the tensor-core rate probe (`tools.probe_int8_mma`). The
package imports `torch`, NumPy, SciPy and PIL only, never JAX and never
`egohmr_tpu`, so it runs on a machine without JAX.

Nothing is imported eagerly here: the hand-written CUDA kernels (under
`csrc/`) are compiled with `nvcc` on first use, by the wrapper that launches
them (`_build.py`).
"""
