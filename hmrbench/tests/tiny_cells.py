"""The cells at tiny widths and shapes for the CPU tests: the same files,
drivers and reference, with these overrides merged in."""
import copy

TINY = {
    "egohmr-ddim5-bulk": {
        "model": dict(pointnet_hidden_dim=32, scene_feat_dim=32, transl_embed_dim=16,
                      timestep_embed_dim=32, input_process_dim=32, gcn_hid_dim=64,
                      gcn_layers=2),
        "inputs": dict(img_size=32, scene_points=256),
        "smpl": dict(num_vertices=66, closed_body=dict(rings=8, slices=8)),
        "diffusion": dict(num_timesteps=10),
        "images_per_request": 4, "distinct_batches": 2, "max_inflight": 2,
        "trace_requests": 2, "check": dict(requests=2)},
    "prohmr-flow": {
        "model": dict(pointnet_hidden_dim=32, scene_feat_dim=32, flow_hidden=64,
                      fc_head_hidden=64),
        "inputs": dict(img_size=32, scene_points=256),
        "smpl": dict(num_vertices=66, closed_body=dict(rings=8, slices=8)),
        "images_per_request": 3, "distinct_batches": 2, "trace_requests": 2,
        "check": dict(requests=2)},
}
# the program in float32 with the plain scene encoder, as the reference runs
F32_PROGRAM = {
    "egohmr-ddim5-bulk": dict(bf16=False, pointnet_impl="xla"),
    "prohmr-flow": dict(pointnet_impl="xla"),
}
SECONDS = {"egohmr-ddim5-bulk": 1.5, "prohmr-flow": 1.0}


def overrides(cell: str, f32: bool = False) -> dict:
    out = copy.deepcopy(TINY[cell])
    if f32:
        out["program"] = dict(out.get("program", {}), **F32_PROGRAM[cell])
    return out


def run(cell: str, *, seed: int = 11, trace: int = 0, f32: bool = False, bench=None):
    """One tiny run of `cell` on the CPU, in this process: the result's
    object."""
    import time

    import torch

    from hmrbench import run as runner

    args = runner.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                         str(SECONDS.get(cell, 1.0)), "--trace", str(trace)])
    kw = {} if bench is None else {"bench": bench}
    return runner.run(args, device=torch.device("cpu"), overrides=overrides(cell, f32),
                      t_start=time.perf_counter(), **kw)
