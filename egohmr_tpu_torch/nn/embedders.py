"""Conditioning heads: timestep embedder, pose/translation encoders and the
betas head (port of egohmr_tpu/nn/embedders.py). Module and key names follow
the reference `state_dict`."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .core import linear, silu


def sinusoidal_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """Fixed sin/cos table [max_len, d_model]."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class TimestepEmbedder(nn.Module):
    def __init__(self, latent_dim: int = 512, max_len: int = 5000):
        super().__init__()
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(),
            nn.Linear(latent_dim, latent_dim))
        # not in the reference state_dict: rebuilt from the formula
        self.register_buffer(
            "pe", torch.tensor(sinusoidal_table(latent_dim, max_len)),
            persistent=False)


def timestep_embed(mod: TimestepEmbedder, timesteps: torch.Tensor) -> torch.Tensor:
    """int [B] -> [B, latent_dim]: MLP(SiLU) over pe[t]."""
    x = mod.pe[timesteps]
    return linear(mod.time_embed[2], silu(linear(mod.time_embed[0], x)))


class InputProcess(nn.Module):
    def __init__(self, in_dim: int = 6, latent_dim: int = 512):
        super().__init__()
        self.poseEmbedding = nn.Linear(in_dim, latent_dim)


def input_process(mod: InputProcess, x: torch.Tensor) -> torch.Tensor:
    """x_t rot6d [B, 24, 6] -> [B, 24, latent]."""
    return linear(mod.poseEmbedding, x)


class TranslEnc(nn.Module):
    def __init__(self, in_dim: int = 3, out_dim: int = 128):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(in_dim, 64), nn.ReLU(),
                                    nn.Linear(64, out_dim))


def transl_enc(mod: TranslEnc, x: torch.Tensor) -> torch.Tensor:
    """[B, 3] -> [B, out_dim]."""
    return linear(mod.layers[2], torch.relu(linear(mod.layers[0], x)))


class FCHeadBeta(nn.Module):
    def __init__(self, in_dim: int, init_betas: Optional[torch.Tensor] = None):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(in_dim, 1024), nn.ReLU(),
                                    nn.Linear(1024, 10))
        if init_betas is None:
            init_betas = torch.zeros(10)
        self.init_betas = nn.Parameter(init_betas.reshape(1, 10).clone())


class FCHead(nn.Module):
    """Stage 1's betas and camera head. `init_betas` [1, 10] and `init_cam`
    [1, 3] are buffers, as in the reference `state_dict`; training hands
    them to AdamW (`train.prohmr_loop.trainable_tensors`), as the JAX package
    trains them."""

    def __init__(self, in_dim: int, hidden: int = 1024,
                 init_betas: Optional[torch.Tensor] = None,
                 init_cam: Optional[torch.Tensor] = None):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(in_dim, hidden), nn.ReLU(),
                                    nn.Linear(hidden, 13))
        if init_betas is None:
            init_betas = torch.zeros(10)
        if init_cam is None:
            init_cam = torch.tensor([0.9, 0.0, 0.0])
        self.register_buffer("init_betas", init_betas.reshape(1, 10).clone().float())
        self.register_buffer("init_cam", init_cam.reshape(1, 3).clone().float())


def fc_head(mod: FCHead, feats: torch.Tensor):
    """[B, ctx] -> (betas [B, 10], cam [B, 3])."""
    offset = linear(mod.layers[2], torch.relu(linear(mod.layers[0], feats)))
    return offset[:, :10] + mod.init_betas, offset[:, 10:] + mod.init_cam


def fc_head_beta(mod: FCHeadBeta, feats: torch.Tensor) -> torch.Tensor:
    """[B, ctx] -> betas [B, 10]."""
    offset = linear(mod.layers[2], torch.relu(linear(mod.layers[0], feats)))
    return offset + mod.init_betas.to(
        torch.promote_types(offset.dtype, mod.init_betas.dtype))
