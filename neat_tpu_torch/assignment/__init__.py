from .clustering import dbscan_cluster_means
from .matching import auction_assignment, masked_assignment
