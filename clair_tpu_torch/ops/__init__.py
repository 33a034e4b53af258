"""The port's CUDA kernels, each behind a wrapper that counts its launches
(``<wrapper>.launches``) and runs its plain PyTorch version on CPU tensors."""


def _wrappers() -> tuple:
    from clair_tpu_torch.ops.bilstm import bilstm_precomputed
    from clair_tpu_torch.ops.bilstm2 import bilstm2
    from clair_tpu_torch.ops.bilstm_stream import bilstm_stream, bilstm_stream_backward
    from clair_tpu_torch.ops.bilstm_train import bilstm_train, bilstm_train_backward
    from clair_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_dgrad, conv3x3_wgrad

    return (bilstm_stream, bilstm_stream_backward, bilstm_train, bilstm_train_backward,
            bilstm_precomputed, bilstm2, conv3x3, conv3x3_dgrad, conv3x3_wgrad)


def launch_counts() -> dict:
    """Each kernel wrapper's name and its launches so far in this process."""
    return {fn.__name__: fn.launches for fn in _wrappers()}


def launches_since(before: dict) -> dict:
    """Each wrapper's launches since ``before`` (a launch_counts())."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def add_launches(total: dict, launches: dict) -> None:
    """Add ``launches`` (counts by wrapper, as from another process) into
    ``total``."""
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in _wrappers():
        fn.launches = 0
