"""Accelerator renderer (L0): SDF font atlas, scene command buffers, and the
jitted tile rasterizer. The accelerator-native replacement for the
reference's Vulkan pipeline (SDF text + spline strips + avatar atlas +
4×MSAA → here: SDF everything + analytic AA, composited per pixel tile).
"""
