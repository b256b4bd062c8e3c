"""Host-side operator builders and the CUDA kernels with their plain
torch versions (``joint_kernel``, ``step_kernel``)."""
