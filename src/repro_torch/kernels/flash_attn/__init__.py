"""One-token attention over a KV cache (flash decode): the CUDA C++
kernel's launcher (:mod:`.flash_attn`, source
``kernels/csrc/flash_decode.cu``), its plain version (:mod:`.ref`) and
the dispatching wrapper (:mod:`.ops`)."""
