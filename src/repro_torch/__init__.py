"""PyTorch/CUDA port of the Optimus serving system (elastic chunked
diffusion decoding over a paged KV pool).  Imports torch and numpy only."""
