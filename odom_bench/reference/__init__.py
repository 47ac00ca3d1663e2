"""The plain reference odometry the port's outputs are held to."""
