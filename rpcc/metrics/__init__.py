"""Evaluation metrics."""

from rpcc.metrics.chamfer import calc_chamfer_distance, nn_distances
from rpcc.metrics.psnr import calc_point_to_point_plane_psnr, psnr
