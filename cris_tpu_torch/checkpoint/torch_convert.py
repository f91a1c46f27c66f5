"""OpenAI CLIP TorchScript archives (``RN50.pt``, ``RN101.pt``, and the
ViT ones such as ``ViT-B-16.pt``) -> the port's CLIP state_dict and
architecture (counterpart of cris_tpu/checkpoint/torch_convert.py:51-110
and 319-328).

The port keeps OpenAI CLIP's parameter names, so nothing is renamed or
transposed: the archive's state_dict is read, its three scalar entries
and BatchNorm's ``num_batches_tracked`` counters are dropped, half
precision is widened to f32, and the architecture is inferred from the
tensor shapes.

``save_clip_torchscript`` is check support, not a path of the port: it
writes the port's CLIP in that format for tests/test_torch_train_entry.py,
tests/test_torch_vit.py and ``chip_smoke.py`` phases 14 and 21 (no
weights ship with the repository), and the package does not export it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..models.clip import CLIPConfig

# scalar entries of a released archive that are not parameters
ARCHIVE_EXTRAS = ("input_resolution", "context_length", "vocab_size")


def infer_clip_config(sd: Mapping[str, torch.Tensor]) -> CLIPConfig:
    """A CLIP's architecture from its state_dict's shapes, as the JAX
    package infers it: a ViT tower when ``visual.proj`` is there (its
    width from ``visual.conv1``, its layers from the attention blocks,
    the resolution patch x grid), else the modified ResNet
    (``transformer_heads`` is width // 64, as for every released
    archive)."""
    if "visual.proj" in sd:
        conv1 = sd["visual.conv1.weight"]
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        vision_width, patch = conv1.shape[0], conv1.shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = patch * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd
                 if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        patch = None
        image_resolution = 32 * round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width,
        transformer_heads=width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )


def load_clip_torchscript(path: str
                          ) -> Tuple[Dict[str, torch.Tensor], CLIPConfig]:
    """(the CLIP state_dict on the CPU in f32 under the port's names, its
    CLIPConfig) of an OpenAI CLIP TorchScript archive."""
    sd = torch.jit.load(path, map_location="cpu").state_dict()
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in sd.items()
          if k not in ARCHIVE_EXTRAS and not k.endswith("num_batches_tracked")}
    return sd, infer_clip_config(sd)


class _Archive(torch.nn.Module):
    """A CLIP under OpenAI CLIP's attribute layout with a released
    archive's scalar entries; the forward only has to be traceable (a
    trace keeps every submodule's tensors)."""

    def __init__(self, clip: torch.nn.Module, image_resolution: int):
        super().__init__()
        for name in ("visual", "transformer", "token_embedding",
                     "positional_embedding", "ln_final", "text_projection",
                     "logit_scale"):
            setattr(self, name, getattr(clip, name))
        self.register_buffer("input_resolution",
                             torch.tensor(image_resolution))
        self.register_buffer("context_length",
                             torch.tensor(clip.positional_embedding.shape[0]))
        self.register_buffer("vocab_size",
                             torch.tensor(clip.token_embedding.num_embeddings))

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return self.ln_final(state) @ self.text_projection


def save_clip_torchscript(clip: torch.nn.Module, path: str,
                          image_resolution: int = 224) -> str:
    """Trace the port's CLIP into a TorchScript archive with a released
    archive's keys (its parameters and buffers under OpenAI's names, and
    ``input_resolution``, ``context_length``, ``vocab_size``); returns
    ``path``."""
    width = clip.ln_final.weight.shape[0]
    traced = torch.jit.trace(_Archive(clip, image_resolution),
                             (torch.zeros(1, width),), check_trace=False,
                             strict=False)
    torch.jit.save(traced, path)
    return path
