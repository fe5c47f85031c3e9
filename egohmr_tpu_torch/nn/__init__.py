"""Modules and forward functions of the two stages' models. The K1 kernel
wrapper (`pointnet_fused`) builds its CUDA library only when first called."""
from .core import (batchnorm, batchnorm_eval, bf16_tensors, cast_params_bf16, is_bf16_copy,
                   linear, mm, silu)
from .embedders import (
    FCHead,
    FCHeadBeta,
    InputProcess,
    TimestepEmbedder,
    TranslEnc,
    fc_head,
    fc_head_beta,
    input_process,
    timestep_embed,
    transl_enc,
)
from .gcn import (
    ModulatedGCN,
    NonLocalBlock,
    modulated_gcn_forward,
    modulated_gcn_forward_tp,
    nonlocal_block,
)
from .pointnet import (
    ResnetPointnet,
    pointnet_forward,
    pointnet_forward_point_sharded,
    pointnet_forward_tp,
)
from .pointnet_fused import (
    pointnet_forward_fused,
    pointnet_fused_feature,
    pointnet_fused_reference,
)
from .resnet import ResNet, resnet_forward
