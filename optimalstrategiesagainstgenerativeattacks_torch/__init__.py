"""PyTorch + CUDA port of the GIM authentication game, for NVIDIA Hopper.

The JAX/Flax package ``optimalstrategiesagainstgenerativeattacks_tpu`` is
the numerical reference; this package mirrors its layout so each module has
a counterpart by name:

  * ``ops/``     plain tensor functions (AdaIN, instance norm, image ops,
                 set statistics, spectral power iteration);
  * ``nn/``      ``nn.Module`` blocks (spectral-norm convs, residual blocks,
                 self-attention, set-statistic heads);
  * ``models/``  each game's authenticator and impersonator (image, Gaussian);
  * ``train/``   losses, the game states, the train steps and loops;
  * ``theory/``  the closed-form game values;
  * ``kernels/`` the hand-written Hopper kernels (Triton AdaIN, CUDA
                 attention core), their plain PyTorch versions and the build;
  * ``port/``    the weight transplant from the JAX parameter trees;
  * ``utils/``   the games' configs.

Tensors at the public functions keep the JAX layout (``[B, S, H, W, C]``);
inside, modules run NCHW tensors in ``torch.channels_last`` memory.  The
package imports neither JAX nor the reference package.
"""

__version__ = "0.1.0"
