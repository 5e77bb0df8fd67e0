"""Native host code of the port: the C++ KITTI image loader (``loader.py``,
built with g++ at first use)."""
