"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel lives in ``deepfm_tpu_torch/csrc/`` and is compiled by
``build.py`` at first use (nvcc, sm_90a, plain C interface, ctypes). Each
wrapper dispatches on its input's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches in a ``launches`` attribute.
"""


def kernel_wrappers() -> dict:
    """Every kernel's wrapper by kernel name; each counts its launches in
    its ``launches`` attribute (only where it launches its kernel)."""
    from deepfm_tpu_torch.ops.kernels.adam import fused_table_adam
    from deepfm_tpu_torch.ops.kernels.attention import (
        attention_block_backward,
        attention_block_forward,
        interacting_backward,
        interacting_forward,
    )
    from deepfm_tpu_torch.ops.kernels.cin import cin_compress_layer
    from deepfm_tpu_torch.ops.kernels.cin_stack import (
        cin_stack_backward,
        cin_stack_bwd_mma,
        cin_stack_forward,
        cin_stack_mma,
    )
    from deepfm_tpu_torch.ops.kernels.gather import row_gather
    from deepfm_tpu_torch.ops.kernels.grad import densify_rows_grad
    from deepfm_tpu_torch.ops.kernels.packed_grad import (
        densify_rows_grad_packed,
    )
    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        segment_sumsq,
        sparse_table_adam,
    )

    return {"cin_stack_fwd": cin_stack_forward,
            "cin_stack_fwd_mma": cin_stack_mma,
            "cin_stack_bwd": cin_stack_backward,
            "cin_stack_bwd_mma": cin_stack_bwd_mma,
            "cin_compress": cin_compress_layer,
            "attention_block_fwd": attention_block_forward,
            "attention_block_bwd": attention_block_backward,
            "interacting_fwd": interacting_forward,
            "interacting_bwd": interacting_backward,
            "densify_rows_grad": densify_rows_grad,
            "segment_sumsq": segment_sumsq,
            "sparse_table_adam": sparse_table_adam,
            "fused_table_adam": fused_table_adam,
            "densify_rows_grad_packed": densify_rows_grad_packed,
            "row_gather": row_gather}


def launch_counts() -> dict[str, int]:
    """Every kernel's launches so far, by kernel name."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
