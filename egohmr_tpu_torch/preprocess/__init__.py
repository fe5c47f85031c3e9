"""Offline scene preprocessing: mesh vertex I/O and the stage-1 (whole
scene) and stage-2 (cube around the body or stage 1's translation) point
clouds."""
