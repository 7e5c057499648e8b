"""PyTorch/CUDA port of the Rocket League RL stack.

Module names follow the JAX package's, so each counterpart is found by the
same path.  Entry points take an explicit ``device`` that defaults to
``"cuda"``; see :func:`reinforcement_learning_torch.device.resolve_device`.
"""
