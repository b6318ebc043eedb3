"""Share-to-community button assets for the gradio demo (reference C19,
utils/share_btn.py).

Minimal fresh implementation: JS that composites the demo's output images
onto a canvas and opens a pre-filled HF discussion; CSS for the button.
Only used by deployments that run the gradio demo on a Space.
"""

COMMUNITY_JS = """
async () => {
  const imgs = Array.from(document.querySelectorAll('#outputs img'));
  if (!imgs.length) { alert('generate an image first'); return; }
  const canvas = document.createElement('canvas');
  const w = Math.max(...imgs.map(i => i.naturalWidth));
  canvas.width = w;
  canvas.height = imgs.reduce((a, i) => a + i.naturalHeight, 0);
  const ctx = canvas.getContext('2d');
  let y = 0;
  for (const img of imgs) {
    ctx.drawImage(img, 0, y);
    y += img.naturalHeight;
  }
  const dataUrl = canvas.toDataURL('image/jpeg', 0.9);
  const title = encodeURIComponent('Rich-text-to-image result');
  const body = encodeURIComponent('![result](' + dataUrl.slice(0, 64) +
    '...)\\n\\n(shared from the rich_text_to_image_tpu demo)');
  window.open('https://huggingface.co/spaces/new-discussion?title=' + title +
              '&description=' + body, '_blank');
}
"""

SHARE_BUTTON_CSS = """
#share-btn {
  background: linear-gradient(90deg, #6366f1, #8b5cf6);
  color: white; border-radius: 8px; padding: 8px 16px;
  border: none; cursor: pointer; font-weight: 600;
}
#share-btn:hover { filter: brightness(1.1); }
"""
