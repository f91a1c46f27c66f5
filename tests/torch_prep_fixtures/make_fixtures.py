"""Write the rasterizer fixture that ``chip_smoke.py`` phase 19 checks on
the card's machine (which has no OpenCV), and the digests OpenCV gives.

    python3 tests/torch_prep_fixtures/make_fixtures.py

Needs cv2 (through ``cris_tpu.data.refer.rasterize_polygons``). Writes
beside this script:

- ``polygons.json``: seeded polygon annotations, each {name, height,
  width, segmentation}: COCO-like lists of 20 to 100 vertices in 1 to 3
  parts at 640 x 480 (``chip_smoke.coco_polygon``), and the cases a
  released annotation can hold that are hardest to fill as OpenCV fills
  them: parts of one and two vertices, repeated and collinear vertices,
  self-intersections, vertices at .5 (rounded half to even) and outside
  the image, thin slivers, 1 x 1 and 3 x 2 images;
- ``digests.json``: the sha256 of each mask's bytes as
  ``cv2.fillPoly`` draws it, with the OpenCV version.

``tests/test_torch_refer.py::test_rasterizer_fixture_matches_cv2_and_its_digests``
holds the port to both.
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import chip_smoke  # noqa: E402
from cris_tpu.data.refer import rasterize_polygons  # noqa: E402


def cases() -> list:
    rng = np.random.RandomState(1919)
    out = []
    for k in range(24):
        seg = chip_smoke.coco_polygon(rng, 480, 640, vertices=(20, 100))
        out.append({"name": f"coco_{k}", "height": 480, "width": 640,
                    "segmentation": seg})
    special = {
        "one_vertex": (40, 50, [[10.5, 20.5], [33.49, 7.51]]),
        "two_vertices": (40, 50, [[2, 2, 7, 5], [45.5, 1.5, 3.5, 38.5]]),
        "repeated": (60, 80, [[5, 5, 5, 5, 70, 10, 70, 10, 70, 10, 40, 55,
                               5, 5]]),
        "collinear": (60, 80, [[0, 0, 20, 20, 40, 40, 60, 60, 30, 30]]),
        "self_intersecting": (120, 160, [[10, 10, 150, 110, 150, 10, 10,
                                          110]]),
        "star": (200, 200, [[100, 5, 160, 190, 5, 70, 195, 70, 40, 190]]),
        "halves": (30, 30, [[0.5, 0.5, 20.5, 1.5, 27.5, 22.5, 3.5, 28.5],
                            [10.5, 10.5, 12.5, 10.5, 11.5, 13.5]]),
        "outside": (100, 120, [[-30, -20, 150, 40, 60, 130, -10, 90],
                               [110, -5, 140, 50, 100, 99.6]]),
        "far_outside": (50, 60, [[-500, -400, 800, 20, 30, 900]]),
        "covering": (48, 64, [[-10, -10, 100, -10, 100, 100, -10, 100]]),
        "border": (480, 640, [[0, 0, 640, 0, 640, 480, 0, 480]]),
        "sliver": (100, 100, [[3, 3, 97, 4, 96, 4.4, 3.2, 3.6]]),
        "vertical_sliver": (100, 100, [[50, 0, 50.4, 99, 50.2, 99.5]]),
        "one_pixel_image": (1, 1, [[0, 0, 0.4, 0.2, 0.2, 0.4]]),
        "tiny_image": (2, 3, [[-1, -1, 4, 0.5, 1, 3]]),
        "empty_list": (10, 10, []),
    }
    for name, (h, w, seg) in special.items():
        out.append({"name": name, "height": h, "width": w,
                    "segmentation": seg})
    return out


def main():
    data = cases()
    digests = []
    for case in data:
        mask = rasterize_polygons(case["segmentation"], case["height"],
                                  case["width"])
        digests.append(hashlib.sha256(mask.tobytes()).hexdigest())
    with open(os.path.join(HERE, "polygons.json"), "w") as f:
        json.dump(data, f, separators=(",", ":"))
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump({"opencv": cv2.__version__, "masks": digests}, f, indent=1)
    print(f"{len(data)} cases, opencv {cv2.__version__}")


if __name__ == "__main__":
    main()
