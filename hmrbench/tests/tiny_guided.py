"""The guided cells at tiny widths and shapes for the CPU tests: the same
files, driver and reference, with these overrides merged in (as
`tiny_cells.py` does for the other cells)."""
import copy

import torch

# a tiny request is hundreds of small ops: at torch's one thread per core a
# host shared with other work slows them up to twentyfold, past the window
torch.set_num_threads(min(2, torch.get_num_threads()))

_STAGE2 = dict(pointnet_hidden_dim=32, scene_feat_dim=32, transl_embed_dim=16,
               timestep_embed_dim=32, input_process_dim=32, gcn_hid_dim=64, gcn_layers=2)
_COMMON = {"model": _STAGE2, "inputs": dict(img_size=32, scene_points=256),
           "smpl": dict(num_vertices=66, closed_body=dict(rings=8, slices=8)),
           "diffusion": dict(num_timesteps=10), "distinct_batches": 2, "max_inflight": 2,
           "trace_requests": 2}
TINY = {
    "egohmr-volsdf-ddpm50": dict(
        _COMMON, collision=dict(net=dict(latent_dim=8, hidden_dim=16, num_layers=3,
                                         part_embed_dim=4, trunc=0.15),
                                ddpm_threshold=3, ddpm_fixed_below=1),
        images_per_request=2, samples_per_image=2, check=dict(requests=2)),
    "egohmr-ddpm50-guided": dict(
        _COMMON, images_per_request=2, samples_per_image=2, check=dict(requests=2)),
}
# the mesh SDF's guidance at the tiny shapes: every step's points fit the
# per-step cap, the scene is cut to half
TINY_MESH_GUIDANCE = dict(backend="sdf", cond_grad_weight=2.0, ddpm_threshold=3,
                          ddpm_fixed_below=1, ddpm_fixed_coeff=0.01, scene_points=128)
# the program in float32 with the plain scene encoder, as the reference runs
F32_PROGRAM = dict(bf16=False, pointnet_impl="xla")
SECONDS = 3.0


def overrides(cell: str, f32: bool = False) -> dict:
    out = copy.deepcopy(TINY[cell])
    program = {}
    if cell == "egohmr-ddpm50-guided":
        program["guidance"] = dict(TINY_MESH_GUIDANCE)
    if f32:
        program.update(F32_PROGRAM)
    if program:
        out["program"] = program
    return out


def run(cell: str, *, seed: int = 11, trace: int = 0, f32: bool = False, bench=None,
        extra=None):
    """One tiny run of `cell` on the CPU, in this process: the result's
    object. `extra`: more overrides, merged last."""
    import time

    from hmrbench import run as runner

    args = runner.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(SECONDS),
                         "--trace", str(trace)])
    kw = {} if bench is None else {"bench": bench}
    ov = overrides(cell, f32)
    for k, v in (extra or {}).items():
        ov[k] = dict(ov.get(k, {}), **v) if isinstance(v, dict) else v
    return runner.run(args, device=torch.device("cpu"), overrides=ov,
                      t_start=time.perf_counter(), **kw)
