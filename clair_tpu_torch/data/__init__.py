from clair_tpu_torch.data.tensor_stream import (  # noqa: F401
    normalize_channels,
    parse_tensor_line,
    tensor_batches_from,
    tensor_line_from,
)
