"""vlrlhf_torch — the PyTorch + CUDA port of vlrlhf_tpu for NVIDIA Hopper.

It imports torch and numpy and never jax or vlrlhf_tpu, so it runs on a
machine without JAX. Subpackages mirror vlrlhf_tpu/ so each module's
counterpart is easy to find:

  ops/       norms, rope, sampling, attention dispatch, and the hand-written
             Hopper kernels (flash forward, decode attention) built from
             csrc/ with nvcc at first use (ops/_build.py)
  models/    config, ViT tower, llama decoder, VLM assembly (nn.Modules)
  utils/     bridge from a vlrlhf_tpu numpy param tree to the port's modules
  data/      the tokenizer / template / processor / collator pieces serving
             needs (copies: the vlrlhf_tpu originals import jax through the
             package __init__)
  generate/  static Generator, continuous-batching engine, HTTP server
  cli/       `serve` entry point
"""

__version__ = "0.1.0"
