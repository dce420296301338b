"""vlrlhf_torch — the PyTorch + CUDA port of vlrlhf_tpu for NVIDIA Hopper.

It imports torch and numpy and never jax or vlrlhf_tpu, so it runs on a
machine without JAX. Subpackages mirror vlrlhf_tpu/ so each module's
counterpart is easy to find:

  ops/       norms, rope, sampling, attention dispatch, and the hand-written
             Hopper kernels (flash forward and backward, decode attention)
             built from csrc/ with nvcc at first use (ops/_build.py)
  models/    config, Ctx and LoRA-carrying Linear, ViT tower, llama decoder
             (training forward with remat), VLM assembly (nn.Modules)
  lora/      LoRA targets, init and delta
  train/     losses, optimizer (the optax chain in tensor code), DPO step,
             loop, metrics, FLOPs model
  utils/     bridge from vlrlhf_tpu numpy param and adapter trees to the
             port's modules and back
  data/      the tokenizer / template / processor / collator / diff-mask
             pieces serving and DPO need (copies, because the vlrlhf_tpu
             originals pull jax in through their package __init__)
  generate/  static Generator, continuous-batching engine, HTTP server
  cli/       `serve` and `dpo` entry points
"""

__version__ = "0.1.0"
