from fealess.parallel import mesh, sharded_icp, sharded_match  # noqa: F401

__all__ = ["mesh", "sharded_match", "sharded_icp"]
