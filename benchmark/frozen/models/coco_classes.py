"""The 80 COCO class names (detector routing table).

Host copy of ``vlfm_tpu/models/coco_classes.py`` (reference:
vlfm/vlm/coco_classes.py), held equal to it by ``tests/test_torch_host.py``:
targets in this list route to the COCO detector at the higher confidence
threshold; everything else goes to the open-vocabulary detector
(base_objectnav_policy.py:221-241).
"""

COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]


def is_coco_target(target: str) -> bool:
    """Any of the '|'-separated class names is a COCO class
    (base_objectnav_policy.py:222-224)."""
    return any(c in COCO_CLASSES for c in target.split("|"))
