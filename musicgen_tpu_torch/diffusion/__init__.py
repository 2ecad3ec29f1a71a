"""The diffusion workload of the port: port of musicgen_tpu/diffusion (a
guided-diffusion / RePaint UNet over piano-roll canvases). No hand-written
kernel: the UNet is convolutions, group norms and matmuls, as the JAX
package leaves it to XLA."""
from .canvas import (
    RandomSnippet,
    canvas_to_notes,
    create_canvas,
    denormalize_canvas,
    normalize_canvas,
)
from .factories import (
    DiffusionDefaults,
    RePaintConf,
    create_classifier,
    create_gaussian_diffusion,
    create_model,
    create_model_and_diffusion,
)
from .gaussian import DiffusionSchedule, GaussianDiffusion, MeanType, VarType
from .respace import SpacedDiffusion, space_timesteps
from .schedule import get_schedule_jump, named_betas
from .trainer import make_diffusion_train_step, train_diffusion
from .unet import EncoderUNetModel, SuperResModel, UNetConfig, UNetModel

__all__ = [
    "RandomSnippet", "canvas_to_notes", "create_canvas",
    "denormalize_canvas", "normalize_canvas",
    "DiffusionDefaults", "RePaintConf", "create_classifier",
    "create_gaussian_diffusion", "create_model", "create_model_and_diffusion",
    "DiffusionSchedule", "GaussianDiffusion", "MeanType", "VarType",
    "SpacedDiffusion", "space_timesteps", "get_schedule_jump", "named_betas",
    "make_diffusion_train_step", "train_diffusion",
    "EncoderUNetModel", "SuperResModel", "UNetConfig", "UNetModel",
]
