"""Relighting of the port (counterpart of tensoflow_tpu/eval/relight.py).

Two paths, as in the JAX package:
  1. ``run_blender_relight``: the bundle for Blender's Cycles (the mesh, the
     vertex materials that ``eval_mat --extract_mats`` bakes, a generated
     Blender script and its JSON), and ``blender --background`` when a
     blender binary is on PATH; otherwise the bundle stays on disk.  The
     script is Blender Python, the JAX package's string byte for byte.
  2. ``relight_direct``: baked surface points re-shaded under a new
     environment cubemap with the training BRDF (GGX specular + Lambert
     diffuse), cosine-sampled light directions and sphere-traced
     visibility, on the card (or the CPU for CPU tensors).

``relight_direct`` draws nothing itself: the azimuth roll of its
direction table comes in as a [pn, 1, 1] tensor of uniforms (``roll``;
None rolls nothing), so a caller chooses its generator.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

BLENDER_SCRIPT = r'''
# Auto-generated Blender driver (reference bridge semantics:
# blender_backend/relight_backend.py): import mesh, attach vertex-color
# principled material, light with an HDRI, render the given poses.
# Targets Blender 4.x APIs with pre-4.0 fallbacks.
import bpy, json, sys, numpy as np
argv = sys.argv[sys.argv.index('--') + 1:]
cfg = json.load(open(argv[0]))

bpy.ops.wm.read_factory_settings(use_empty=True)
if hasattr(bpy.ops.wm, 'ply_import'):      # Blender >= 4.0
    bpy.ops.wm.ply_import(filepath=cfg['mesh'])
else:                                      # legacy importer (< 4.0)
    bpy.ops.import_mesh.ply(filepath=cfg['mesh'])
obj = bpy.context.selected_objects[0]
if cfg.get('trans'):
    # z-up flip for GlossySynthetic-convention meshes
    # (ref: relight_backend.py:48-49 --trans)
    obj.rotation_euler[0] = np.pi / 2

albedo = np.load(cfg['albedo'])
rough = np.load(cfg['roughness'])
metal = np.load(cfg['metallic'])
mesh = obj.data
# vectorized per-corner color assignment (foreach_set; the per-loop python
# assignment the reference uses takes minutes on 500k-vert meshes)
nloops = len(mesh.loops)
vidx = np.empty(nloops, np.int32)
mesh.loops.foreach_get('vertex_index', vidx)
col_a = np.ones((nloops, 4), np.float32)
col_a[:, :3] = albedo[vidx]
col_m = np.zeros((nloops, 4), np.float32)
col_m[:, 0] = metal[vidx, 0]
col_m[:, 1] = rough[vidx, 0]
col_m[:, 3] = 1.0
if hasattr(mesh, 'color_attributes'):      # Blender >= 3.2
    ca = mesh.color_attributes.new('albedo', 'FLOAT_COLOR', 'CORNER')
    cm = mesh.color_attributes.new('metal_rough', 'FLOAT_COLOR', 'CORNER')
else:
    ca = mesh.vertex_colors.new(name='albedo')
    cm = mesh.vertex_colors.new(name='metal_rough')
ca.data.foreach_set('color', col_a.reshape(-1))
cm.data.foreach_set('color', col_m.reshape(-1))

mat = bpy.data.materials.new('baked')
mat.use_nodes = True
nt = mat.node_tree
bsdf = nt.nodes['Principled BSDF']
attr_a = nt.nodes.new('ShaderNodeVertexColor'); attr_a.layer_name = 'albedo'
attr_m = nt.nodes.new('ShaderNodeVertexColor'); attr_m.layer_name = 'metal_rough'
try:                                       # Blender >= 3.3 / 4.x
    sep = nt.nodes.new('ShaderNodeSeparateColor')
    sep_in, sep_r, sep_g = sep.inputs['Color'], sep.outputs['Red'], sep.outputs['Green']
except RuntimeError:                       # removed ShaderNodeSeparateRGB fallback
    sep = nt.nodes.new('ShaderNodeSeparateRGB')
    sep_in, sep_r, sep_g = sep.inputs['Image'], sep.outputs['R'], sep.outputs['G']
nt.links.new(attr_a.outputs['Color'], bsdf.inputs['Base Color'])
nt.links.new(attr_m.outputs['Color'], sep_in)
nt.links.new(sep_r, bsdf.inputs['Metallic'])
nt.links.new(sep_g, bsdf.inputs['Roughness'])
obj.data.materials.append(mat)

world = bpy.data.worlds.new('relight'); bpy.context.scene.world = world
world.use_nodes = True
env = world.node_tree.nodes.new('ShaderNodeTexEnvironment')
env.image = bpy.data.images.load(cfg['hdr'])
world.node_tree.links.new(env.outputs['Color'],
                          world.node_tree.nodes['Background'].inputs['Color'])

scene = bpy.context.scene
scene.render.engine = 'CYCLES'
scene.render.film_transparent = True
scene.render.resolution_x = cfg['width']
scene.render.resolution_y = cfg['height']
for i, pose in enumerate(cfg['poses']):
    cam_data = bpy.data.cameras.new(f'cam{i}')
    cam = bpy.data.objects.new(f'cam{i}', cam_data)
    bpy.context.collection.objects.link(cam)
    cam.matrix_world = np.array(pose).T.tolist()
    scene.camera = cam
    scene.render.filepath = cfg['out_pattern'] % i
    bpy.ops.render.render(write_still=True)
'''


def run_blender_relight(cfg, hdr_path: Optional[str] = None,
                        poses=None, hw=(800, 800)) -> Optional[str]:
    """Write the relight bundle under data/relight/<name>/ and run blender
    when one is on PATH (ref: eval_mat.py:141-152).  Returns the bundle's
    directory after a render, None when no blender was found."""
    out_dir = os.path.join('data/relight', cfg['name'])
    os.makedirs(out_dir, exist_ok=True)
    script = os.path.join(out_dir, 'relight_driver.py')
    with open(script, 'w') as f:
        f.write(BLENDER_SCRIPT)
    mats = os.path.join('data/materials', cfg['name'])
    bundle = {
        'mesh': cfg['mesh'],
        'albedo': os.path.join(mats, 'albedo.npy'),
        'roughness': os.path.join(mats, 'roughness.npy'),
        'metallic': os.path.join(mats, 'metallic.npy'),
        'hdr': hdr_path or '',
        'trans': bool(cfg.get('trans', False)),
        'poses': [] if poses is None else [np.asarray(p).tolist()
                                           for p in poses],
        'width': hw[1], 'height': hw[0],
        'out_pattern': os.path.join(out_dir, 'relit_%03d.png'),
    }
    cfg_path = os.path.join(out_dir, 'relight_cfg.json')
    with open(cfg_path, 'w') as f:
        json.dump(bundle, f)
    blender = shutil.which('blender')
    if blender is None:
        print(f'blender not found; relight bundle written to {out_dir}')
        return None
    subprocess.check_call([blender, '--background', '--python', script,
                           '--', cfg_path])
    return out_dir


@torch.no_grad()
def relight_direct(mat_params, mc_cfg, grid, unit_size: float, aabb, verts,
                   normals, env_cubemap, rays_view, roll=None,
                   n_samples: int = 128, return_hits: bool = False):
    """Shade surface points [pn,3] (normals [pn,3], view directions
    ``rays_view`` [pn,3] pointing away from the surface) under
    ``env_cubemap`` [6,R,R,3] (linear): ``n_samples`` cosine-sampled
    directions a point, each occluded where a sphere trace from
    o + 2 unit_size d hits the baked SDF ``grid``; the mean of
    weights * env * visibility / pdf over the samples, gated by n.l > 0,
    in sRGB, clipped to [0, 1].  ``roll`` [pn,1,1] uniforms roll each
    point's azimuths.  Returns colours [pn,3], and with ``return_hits``
    the secondary hits [pn, n_samples] too."""
    from ..fields import mc_shading
    from ..ops import cubemap as cm
    from ..ops import sdf_trace
    from ..ops.brdf import specular_weight
    from ..ops.math import linear_to_srgb, safe_normalize, saturate_dot
    from ..ops.samplers import direction_table, sample_diffuse_directions

    view = safe_normalize(rays_view)
    metallic, roughness, albedo = mc_shading.predict_materials(
        mat_params, mc_cfg, verts, aabb)
    dirs, _, pdf, _ = sample_diffuse_directions(
        direction_table(n_samples, verts.device), normals, view, roll)
    pn, sn, _ = dirs.shape
    o = verts[:, None, :].expand(pn, sn, 3).reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    hit = sdf_trace.sphere_trace(grid, o + 2 * unit_size * d, d)[3]
    vis = 1.0 - hit.reshape(pn, sn, 1).to(verts.dtype)
    env = cm.sample_cubemap(env_cubemap, d).reshape(pn, sn, 3)

    kd = (1.0 - metallic)[:, None, :]
    diffuse_w = albedo[:, None, :] * kd * (
        saturate_dot(dirs, normals[:, None, :]) / np.pi)
    f0 = 0.04 * (1.0 - metallic) + metallic * albedo
    spec_w, nol = specular_weight(normals[:, None, :], view[:, None, :],
                                  dirs, f0[:, None, :],
                                  roughness[:, None, :])
    weights = (diffuse_w + spec_w) * (nol > 0)
    colors = torch.mean(weights * env * vis / torch.clamp(pdf, min=1e-6), 1)
    colors = torch.clamp(linear_to_srgb(colors), 0.0, 1.0)
    if return_hits:
        return colors, hit.reshape(pn, sn)
    return colors
