"""ActiveCoSLAM on PyTorch: the uncertainty (beta) head and
information-gain keyframe selection (counterpart of coslam_tpu/active/;
the reference's ActiveCoSLAM/)."""

from .scene_rep import ActiveJointEncoding  # noqa: F401
from .slam import ActiveCoSLAM  # noqa: F401
