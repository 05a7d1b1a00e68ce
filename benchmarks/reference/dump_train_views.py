"""Dump the rendered training views (the exact inputs make_sequence.py
trains the seq bank from — same seed, same rng consumption order) to
<seq>/train/ as color/depth/mask pngs, so the C++ reference's addTemplate
loop and fealess's training path can be benchmarked on identical
data (BASELINE.md training throughput row).
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def dump(seq_dir: str) -> str:
    import cv2

    from make_sequence import model_cloud, render, training_poses

    out = os.path.join(seq_dir, "train")
    if os.path.exists(os.path.join(out, "color_000.png")):
        return out
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(5)          # matches make_sequence.build
    pts, colors = model_cloud()
    for i, (r, t) in enumerate(training_poses()):
        bgr, depth, mask = render(pts, colors, r, t, rng)
        cv2.imwrite(os.path.join(out, f"color_{i:03d}.png"), bgr)
        cv2.imwrite(os.path.join(out, f"depth_{i:03d}.png"), depth)
        cv2.imwrite(os.path.join(out, f"mask_{i:03d}.png"),
                    mask.astype(np.uint8) * 255)
    return out


if __name__ == "__main__":
    seq = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "seq")
    print(dump(seq))
