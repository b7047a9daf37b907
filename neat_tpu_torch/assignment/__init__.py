from .matching import auction_assignment, masked_assignment
