"""PyTorch/CUDA port of tpu_asr for one NVIDIA H100 (see README.md)."""
