"""JPEG fixtures: small baseline, progressive, grey and restart-interval
files and a 1600x900 nuScenes-like CAM_FRONT frame, with the pixels
imageio gives for them (make_fixtures.py writes them)."""

import os

FIXTURE_DIR = os.path.dirname(os.path.abspath(__file__))
