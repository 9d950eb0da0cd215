"""Native host code of the port (C++ built with g++ at first use)."""
