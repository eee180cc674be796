"""The in-the-wild video demo: detector, tracker, crops, backbones' inputs,
camera fit, renderer and the pipeline that drives them."""

from pmce_tpu_torch.demo.camera import (  # noqa: F401
    convert_crop_cam_to_orig_img,
    fit_cam_closed_form,
    fit_cam_iterative,
)
from pmce_tpu_torch.demo.pipeline import (  # noqa: F401
    DemoConfig,
    DemoModels,
    DemoPipeline,
    demo_window_list,
)
from pmce_tpu_torch.demo.preprocess import crop_resize_normalize  # noqa: F401
from pmce_tpu_torch.demo.renderer import Renderer  # noqa: F401
from pmce_tpu_torch.demo.tracker import BBoxTracker, track_video  # noqa: F401
