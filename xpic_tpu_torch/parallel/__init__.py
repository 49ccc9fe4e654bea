"""The fused ECSIM timestep."""
