"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
and the device dispatch the models call (``ops``).  Importing this
package builds nothing: the CUDA library is built at first launch."""
